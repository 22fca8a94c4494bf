"""K3 and K9 as three passes (booster_gym_torch/algo/update_kernel.py,
csrc/update.cu): pass 1 writes every layer's x_l and dz_l to a scratch,
pass 2 forms the weight gradients as a split-K product over slabs of rows,
pass 3 adds the slabs in order.

Here on the CPU: the row plan (slabs of whole pass-2 steps that cover the
rows once, in order), the scratch layout that csrc/update.cu states against
the layer widths and FusedUpdate.cut_scratch's views of it, pass 1's tile
block as csrc/update.cu sizes it from the widths (tile rows, the weight
ring's chunk and depth; its constexprs compiled with the host's g++), and
pass 2's plain version (the slab-by-slab sums) against the one-product
weight gradients of _loss_grads.  The tests marked `cuda` hold the layout that the
kernel library reports to that statement, both kernels against
their plain versions on the card at N = 98,304 and at a ragged N, repeat
them bitwise, and check pass 2 against pass 1's own scratch rows; they skip
without a card.  This file imports nothing of JAX (`pytest --noconftest -m
cuda` runs it on the card).
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

from booster_gym_torch import kernel_build
from booster_gym_torch.algo import update_kernel as uk
from booster_gym_torch.testing import anchor_case, seeded_network, update_case

# the kernels against their plain versions: test_torch_kernel.py's TOL
TOL = {"f32": dict(val=2e-4, grad=1e-4), "bf16": dict(val=2.0 ** -7, grad=2.5 * 2.0 ** -8)}
# pass 2 against dz^T x of its own rows, and the slab sums against one
# product: the same f32 products summed in another order
TOL_SPLIT = 1e-4


def rel_err(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


# csrc/update.cu's scratch layout and pass-2 sizes, as its header states
# them: x_0 [N, 64] shared, then per net x_1, x_2, x_3, dz_0, dz_1, dz_2 at
# the layer widths and dz_3 16 wide; 32 rows a pass-2 step, 128 x 128 tiles
# of dW.  The kernel library reports its own (FusedUpdate.info), which the
# card test below holds to this.
X0W, DZ3W, STEP, TILE = 64, 16, 32, 128


def spec_layout(layers):
    """({net: [(x offset, x width, dz offset, dz width)] per layer}, width,
    pass-2 tiles) of the layer widths, in values per row."""
    out, off, tiles = {}, X0W, 0
    for net in ("actor", "critic"):
        widths = [o for _, _, o, _ in layers[net]]          # outputs of layers 0-3
        x_off = [0] + [off + sum(widths[:l - 1]) for l in (1, 2, 3)]
        dz0 = off + sum(widths[:3])
        xw, dzw = [X0W] + widths[:3], widths[:3] + [DZ3W]
        out[net] = [(x_off[l], xw[l], dz0 + sum(widths[:l]), dzw[l]) for l in range(4)]
        tiles += sum(-(-a // TILE) * -(-b // TILE) for a, b in zip(xw, dzw))
        off = dz0 + sum(widths[:3]) + DZ3W
    return out, off, tiles


@pytest.mark.parametrize("n", [1, 63, 64, 7000, 98304])
def test_row_plan_covers_the_rows_once_in_order(n):
    tiles = spec_layout(update_case("f32", 1, 2, "cpu")[0].layers)[2]
    for slots in (264, 16):
        nslab, rows = uk.row_plan(n, tiles, STEP, slots)
        assert rows % STEP == 0 and nslab >= 1
        slabs = [(s * rows, min((s + 1) * rows, n)) for s in range(nslab)]
        steps = [(lo, min(lo + STEP, hi)) for a, hi in slabs for lo in range(a, hi, STEP)]
        covered = np.concatenate([np.arange(a, b) for a, b in steps])
        assert np.array_equal(covered, np.arange(n))            # once each, in order
        assert all(b > a for a, b in slabs)                      # no empty slab
        assert nslab == 1 or min(b - a for a, b in slabs[:-1]) >= uk.MIN_SLAB_ROWS
        assert nslab == 1 or nslab * tiles <= slots             # one wave of blocks
    if n == 98304:
        assert uk.row_plan(n, tiles, STEP, 264) == (17, 5792)


def test_scratch_layout_follows_the_layer_widths():
    fused = update_case("bf16", 1, 2, "cpu")[0]
    layout, width, tiles = spec_layout(fused.layers)
    assert width == 2400 and tiles == 15
    # x_0 [N, 64] then per net x1-x3 and dz0-dz3, disjoint and without gaps
    spans = [(0, X0W)]
    for net in ("actor", "critic"):
        for l, ((x_off, xw, dz_off, dzw), (_, _, o, i)) in enumerate(zip(layout[net],
                                                                         fused.layers[net])):
            assert xw >= i and dzw >= o and xw % 8 == 0 and dzw % 8 == 0
            if l > 0:
                spans.append((x_off, x_off + xw))
            spans.append((dz_off, dz_off + dzw))
    spans.sort()
    assert spans[0][0] == 0 and spans[-1][1] == width
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    # cut_scratch finds each layer's rows where the layout puts them
    n = 5
    flat = torch.arange(n * width, dtype=torch.float32)
    for (net, l), (x, dz) in fused.cut_scratch(flat, n, layout).items():
        x_off, xw, dz_off, dzw = layout[net][l]
        _, _, o, i = fused.layers[net][l]
        assert x.shape == (n, i) and dz.shape == (n, o)
        assert x[2, 3] == x_off * n + 2 * xw + 3 and dz[4, 0] == dz_off * n + 4 * dzw
    # other widths move the layout with them
    layers = {"actor": [(0, 0, 64, 47), (0, 0, 32, 64), (0, 0, 96, 32), (0, 0, 12, 96)],
              "critic": [(0, 0, 128, 61), (0, 0, 64, 128), (0, 0, 32, 64), (0, 0, 1, 32)]}
    _, width, tiles = spec_layout(layers)
    assert width == 64 + 2 * (64 + 32 + 96) + 16 + 2 * (128 + 64 + 32) + 16
    assert tiles == 4 + 4                                     # one 128 x 128 tile a layer


def source_tile_shape(sizes, tmp_path):
    """(TN, ST) of csrc/update.cu's tile block for bf16 and then f32 at these
    -D sizes: the build's sizes (the text from `#ifndef NOBS` to the line
    that ends them), compiled for the host with the CUDA qualifiers and the
    bf16 type stubbed."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    src = open(kernel_build.source_path(uk.SOURCE)).read()
    part = src[src.index("#ifndef NOBS"):src.index("// ---- end of the build's sizes")]
    stub = ("#include <cstddef>\n#include <cstdio>\n#include <type_traits>\n"
            "#define __host__\n#define __device__\n#define __forceinline__ inline\n"
            "struct __nv_bfloat16 { unsigned short x; };\ninline float __bfloat162float(__nv_bfloat16) { return 0; }\n"
            "inline __nv_bfloat16 __float2bfloat16_rn(float) { return {}; }\n")
    show = "".join(f'printf("%d %d ", CT<{t}>::TN, CT<{t}>::ST);' for t in ("__nv_bfloat16", "float"))
    cpp, exe = tmp_path / "tile.cpp", tmp_path / "tile"
    cpp.write_text(stub + part + "int main() { " + show + " }\n")
    subprocess.run([cxx, "-std=c++17", *[f"-D{k}={v}" for k, v in sizes.items()], str(cpp),
                    "-o", str(exe)], check=True)
    out = [int(v) for v in subprocess.run([str(exe)], check=True, capture_output=True,
                                          text=True).stdout.split()]
    return tuple(out[:2]), tuple(out[2:])


@pytest.mark.parametrize("dims,bf16,f32", [
    # T1: 64-row tiles, a ring of 3 chunks
    ((12, 47, 14), (64, 3), (32, 3)),
    # T1Standup's 434-wide critic input: 32-row tiles, 7 chunks
    ((12, 420, 14), (32, 7), (16, 7)),
    # T1Serial's 23 actions: 64-row tiles, 2 chunks in bf16
    ((23, 80, 14), (64, 2), (32, 3)),
])
def test_tile_block_picks_its_ring_from_the_widths(dims, bf16, f32, tmp_path):
    """K3's pass 1 keeps the tile rows of tile_rows (the order in which a
    block adds its stat partials rests on them) and fills the rest of the
    block's shared memory with the weight ring: as many chunks as fit."""
    fused = seeded_network("bf16", "cpu", 0, dims)
    sizes = uk.FusedUpdate(fused, 0.2, 10.0).sizes
    assert source_tile_shape(sizes, tmp_path) == (bf16, f32)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("slots", [264, 32])   # 14 and 2 slabs of 7,000 rows
def test_split_k_weight_grads_match_one_product(dtype, slots):
    """Pass 2's plain version: every layer's dz^T x and row sum slab by slab
    in slab order equal _loss_grads's one-product gradients to the f32
    summation tolerance; everything else is the same tensor."""
    T, B = 7, 1000
    fused, p, staged, prep, d = update_case(dtype, T, B, "cpu", seed=3)
    n = T * B
    plan = uk.row_plan(n, spec_layout(fused.layers)[2], STEP, slots)
    assert plan[0] > 1
    x = prep["obsc"].reshape(-1, fused.num_crit)[:n]
    args = (staged, p, x, prep["act"].reshape(n, 12), d["adv"].reshape(n), d["ret"].reshape(n),
            prep["old_logp"].reshape(n), None, n)
    g, st, mu, val, logp = fused._loss_grads(*args)
    g_s, st_s, mu_s, val_s, logp_s = fused._loss_grads(*args, plan=plan)
    for net in ("actor", "critic"):
        for w, b, o, i in fused.layers[net]:
            assert rel_err(g_s[w:w + o * i], g[w:w + o * i]) <= TOL_SPLIT, (net, o, i)
            assert rel_err(g_s[b:b + o], g[b:b + o]) <= TOL_SPLIT, (net, o, "bias")
    assert torch.equal(g_s[fused.logstd_slice], g[fused.logstd_slice])
    assert all(torch.equal(a, b) for a, b in ((mu, mu_s), (val, val_s), (logp, logp_s)))


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def check_weight_grads(fused, g, g_p, tol, n, dev):
    """g against the plain version per leaf, and pass 2 against the product
    of pass 1's own scratch rows."""
    for net in ("actor", "critic"):
        for w, b, o, i in fused.layers[net]:
            assert rel_err(g[w:w + o * i], g_p[w:w + o * i]) <= tol, (net, o, i)
            assert rel_err(g[b:b + o], g_p[b:b + o]) <= tol, (net, o, "bias")
    assert rel_err(g[fused.logstd_slice], g_p[fused.logstd_slice]) <= 10 * tol
    views = fused.scratch_views(dev, n)
    for (net, l), (x, dz) in views.items():
        w, b, o, i = fused.layers[net][l]
        assert rel_err(g[w:w + o * i].view(o, i), dz.float().T @ x.float()) <= TOL_SPLIT
        assert rel_err(g[b:b + o], dz.float().sum(0)) <= TOL_SPLIT


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_update_info_layout_matches_the_spec_on_card(gpu, dtype):
    fused = update_case(dtype, 1, 2, gpu)[0]
    info = fused.info(gpu)
    layout, width, tiles = spec_layout(fused.layers)
    assert info["layout"] == layout
    assert (info["scratch_width"], info["pass2_tiles"], info["pass2_rows"]) == (width, tiles, STEP)


# 98,304: the main path's N; 24 x 4097 = 98,328 leaves the last tile of
# pass 1, the last slab and its last step of pass 2 ragged
SHAPES = [(24, 4096), (24, 4097)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("T,B", SHAPES)
def test_grads_stats_passes_match_plain_on_card(gpu, dtype, T, B):
    torch.backends.cuda.matmul.allow_tf32 = False
    fused, p, staged, prep, d = update_case(dtype, T, B, gpu, seed=B)
    mean, rstd = d["adv"].mean(), 1.0 / (d["adv"].std() + 1e-8)
    args = (staged, p, prep, d["adv"], d["ret"], mean, rstd, False)
    g, st, mu, logp = fused.grads_stats(*args)
    g2, st2, mu2, logp2 = fused.grads_stats(*args)
    g_p, st_p, mu_p, logp_p = fused.grads_stats_plain(*args)
    torch.cuda.synchronize()
    assert fused.grads_stats_launches == 2
    assert torch.equal(g, g2) and torch.equal(mu, mu2) and torch.equal(logp, logp2)
    assert all(torch.equal(st[k], st2[k]) for k in st)
    tol = TOL[dtype]
    assert rel_err(mu, mu_p) <= tol["val"] and rel_err(logp, logp_p) <= 10 * tol["val"]
    check_weight_grads(fused, g, g_p, tol["grad"], T * B, gpu)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("T,B", SHAPES)
def test_grads_passes_match_plain_on_card(gpu, dtype, T, B):
    torch.backends.cuda.matmul.allow_tf32 = False
    fused, p, d = anchor_case(seeded_network(dtype, gpu, B), T, B, gpu, seed=B)
    args = (p, d["obs"], d["priv"], d["act"], d["adv"], d["ret"], d["old_logp"])
    g, mu, val = fused.grads(*args)
    g2, mu2, val2 = fused.grads(*args)
    g_p, mu_p, val_p = fused.grads_plain(*args)
    torch.cuda.synchronize()
    assert fused.grads_launches == 2
    assert torch.equal(g, g2) and torch.equal(mu, mu2) and torch.equal(val, val2)
    tol = TOL[dtype]
    assert rel_err(mu, mu_p) <= tol["val"] and rel_err(val, val_p) <= tol["val"]
    check_weight_grads(fused, g, g_p, tol["grad"], T * B, gpu)
