"""The port's terrain (booster_gym_torch/terrain) against the JAX package's.

The height field is numpy from a seed on both sides and must be equal
bitwise.  The direct queries (heights, normals, heights_and_normals) are the
same f32 bilinear formulas: atol 1e-6.  The sampler's plain version is held
against the JAX package's Pallas sampler in interpret mode under
jit_nofusion, as tests/test_terrain.py runs it, at that test's own
tolerance, atol 2e-5 (the kernel sums the four bilinear terms in another
order and multiplies by 1 / hs where the plain version divides).  Query
points are kept 1e-3 cells off grid lines, where the slopes jump.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from booster_gym_tpu.terrain import Terrain as JaxTerrain
from booster_gym_tpu.terrain.sample_kernel import build_shift_table
from booster_gym_tpu.terrain.sample_kernel import make_terrain_sampler as jax_make_sampler
from booster_gym_tpu.utils.compile import jit_nofusion

from booster_gym_torch.terrain import Terrain
from booster_gym_torch.terrain.sample_kernel import make_terrain_sampler
from booster_gym_torch.testing import off_grid_lines, sampler_inputs
from booster_gym_torch.utils.config import load_task_cfg

T1_BLOCK = load_task_cfg("T1")["terrain"]
SMALL_BLOCK = dict(T1_BLOCK, num_terrains=2, terrain_width=4.0, terrain_length=4.0,
                   border_size=2.0)
BLOCKS = {"t1": T1_BLOCK, "small": SMALL_BLOCK}


@pytest.fixture(scope="module", params=["t1", "small"])
def terrains(request):
    cfg = BLOCKS[request.param]
    return JaxTerrain(cfg, seed=3), Terrain(cfg, seed=3)


def test_field_equals_jax_bitwise(terrains):
    jt, tt = terrains
    assert tt.height_field.dtype == torch.float32
    np.testing.assert_array_equal(tt.height_field.numpy(), np.asarray(jt.height_field))
    assert (tt.border_pixels, tt.env_width, tt.env_length) == (
        jt.border_pixels, jt.env_width, jt.env_length)


def test_t1_field_shape_and_content():
    t = Terrain(T1_BLOCK, seed=3)
    assert tuple(t.height_field.shape) == (900, 200)
    hf = t.height_field.numpy()
    assert np.all(hf[:50] == 0) and np.all(hf[:, :50] == 0)        # the flat border
    assert 0.02 < hf[50:450, 50:150].max() <= 0.05 + 1e-6            # random_uniform tiles
    assert set(np.unique(np.abs(hf[450:850, 50:150]))) <= {np.float32(0), np.float32(0.01),
                                                           np.float32(0.02)}


def test_direct_queries_match_jax(terrains):
    """256 random xy, some outside the field (clamped to it): atol 1e-6."""
    jt, tt = terrains
    rng = np.random.default_rng(0)
    span = np.array([jt.env_width, jt.env_length]) + 2 * jt.border_size + 6.0
    xy = rng.uniform(0, 1, (256, 2)) * span - jt.border_size - 3.0
    xy = off_grid_lines(xy, jt)
    jxy, txy = jnp.asarray(xy), torch.as_tensor(xy)
    np.testing.assert_allclose(tt.heights(txy).numpy(), np.asarray(jt.heights(jxy)), atol=1e-6)
    np.testing.assert_allclose(tt.normals(txy).numpy(), np.asarray(jt.normals(jxy)), atol=1e-6)
    h, n = tt.heights_and_normals(txy)
    jh, jn = jt.heights_and_normals(jxy)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-6)
    np.testing.assert_allclose(n.numpy(), np.asarray(jn), atol=1e-6)
    # the field as an explicit operand, and a leading batch shape
    h2 = tt.heights(txy.reshape(16, 16, 2), tt.height_field.clone())
    assert torch.equal(h2.reshape(-1), tt.heights(txy))
    assert float(h.abs().max()) > 0


@pytest.mark.parametrize("B,N", [(256, 33), (256, 65), (100, 65)])
@pytest.mark.parametrize("case", ["inside", "clamped"])
def test_sampler_plain_matches_jax_sampler(B, N, case):
    """atol 2e-5 on heights and normals.  `inside`: queries within 0.55 m of
    the root, where the sampler also equals the direct queries.  `clamped`:
    queries up to 2 m away and roots at the field's edge, where it clamps
    to its patch and must still equal the JAX sampler, not heights()."""
    jt, tt = JaxTerrain(T1_BLOCK, seed=3), Terrain(T1_BLOCK, seed=3)
    clamped = case == "clamped"
    root, pts = sampler_inputs(jt, B, N, 2.0 if clamped else 0.55, clamped, seed=B + N)
    jsample = jit_nofusion(jax_make_sampler(jt, N, interpret=True))
    jh, jn = jsample(build_shift_table(jt.height_field), jnp.asarray(root), jnp.asarray(pts))
    sample = make_terrain_sampler(tt, N, "cpu")
    h, n = sample(tt.height_field, torch.as_tensor(root), torch.as_tensor(pts))
    assert h.shape == (B, N) and n.shape == (B, N, 3) and sample.launches == 0
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=2e-5)
    np.testing.assert_allclose(n.numpy(), np.asarray(jn), atol=2e-5)
    h_direct, n_direct = tt.heights_and_normals(torch.as_tensor(pts))
    if clamped:
        assert float((h - h_direct).abs().max()) > 1e-3   # the patch clamp shows
    else:
        np.testing.assert_allclose(h.numpy(), h_direct.numpy(), atol=2e-5)
        np.testing.assert_allclose(n.numpy(), n_direct.numpy(), atol=2e-5)


def test_sampler_refuses_plane_and_wrong_inputs():
    plane = Terrain({"type": "plane"})
    with pytest.raises(ValueError, match="heightfield"):
        make_terrain_sampler(plane, 9, "cpu")
    with pytest.raises(ValueError, match="Invalid terrain type"):
        Terrain({"type": "mesh"})


def test_plane_queries():
    t = Terrain({"type": "plane", "static_friction": 1.0, "restitution": 0.0})
    xy = torch.zeros(4, 2)
    up = np.tile([0, 0, 1.0], (4, 1))
    assert t.height_field is None
    assert np.all(t.heights(xy).numpy() == 0)
    np.testing.assert_array_equal(t.normals(xy).numpy(), up)
    h, n = t.heights_and_normals(xy)
    assert np.all(h.numpy() == 0)
    np.testing.assert_array_equal(n.numpy(), up)
