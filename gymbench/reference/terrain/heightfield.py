"""Terrain: heightfield generation and queries on the device (port of
booster_gym_tpu/terrain/heightfield.py).

The generators are numpy and draw from np.random.default_rng(seed), so the
field equals the JAX package's bitwise.  Contact consumes the heightfield
directly (depth and normal per sample point); there is no triangle mesh.
World (0, 0) maps to grid index border_pixels.

heights / normals / heights_and_normals are the direct queries for small
sets (roots, resets, reset_all) and for the xla engine.  They clamp to the
whole field.  The per-step query of every contact point goes through
terrain/sample_kernel.py, which clamps to a patch around each root.
"""

import numpy as np
import torch


def _pyramid_sloped(h, slope, horizontal_scale, vertical_px, platform_size=3.0):
    """Product-pyramid slope with a flat central platform."""
    nx, ny = h.shape
    cx, cy = nx // 2, ny // 2
    x = (cx - np.abs(cx - np.arange(nx))) / cx
    y = (cy - np.abs(cy - np.arange(ny))) / cy
    max_h = slope * horizontal_scale * cx / vertical_px  # in raw units
    h += (max_h * x[:, None] * y[None, :]).astype(h.dtype)
    ps = int(platform_size / horizontal_scale / 2)
    x1, y1 = cx - ps, cy - ps
    platform_h = h[x1, y1]
    lo, hi = min(platform_h, 0), max(platform_h, 0)
    np.clip(h, lo, hi, out=h)
    return h


def _random_uniform(h, rng, min_height, max_height, step, downsampled_scale,
                    horizontal_scale, vertical_px):
    """Random heights on a coarse grid, bilinearly upsampled."""
    nx, ny = h.shape
    levels = np.arange(min_height, max_height + step, step) / vertical_px
    dx = max(1, int(nx * horizontal_scale / downsampled_scale))
    dy = max(1, int(ny * horizontal_scale / downsampled_scale))
    coarse = rng.choice(levels, size=(dx, dy))
    xi = np.linspace(0, dx - 1, nx)
    yi = np.linspace(0, dy - 1, ny)
    x0 = np.clip(xi.astype(int), 0, dx - 2)
    y0 = np.clip(yi.astype(int), 0, dy - 2)
    fx = (xi - x0)[:, None]
    fy = (yi - y0)[None, :]
    up = (
        coarse[x0][:, y0] * (1 - fx) * (1 - fy)
        + coarse[x0 + 1][:, y0] * fx * (1 - fy)
        + coarse[x0][:, y0 + 1] * (1 - fx) * fy
        + coarse[x0 + 1][:, y0 + 1] * fx * fy
    )
    h += up.astype(h.dtype)
    return h


def _discrete_obstacles(h, rng, max_height, min_size, max_size, num_rects,
                        horizontal_scale, vertical_px, platform_size=3.0):
    """Random raised and sunken rectangles plus a flat central platform."""
    nx, ny = h.shape
    hm = max_height / vertical_px
    heights = np.array([-hm, -hm / 2, hm / 2, hm])
    for _ in range(num_rects):
        w = int(rng.uniform(min_size, max_size) / horizontal_scale)
        l = int(rng.uniform(min_size, max_size) / horizontal_scale)
        x = rng.integers(0, max(1, nx - w))
        y = rng.integers(0, max(1, ny - l))
        h[x:x + w, y:y + l] = rng.choice(heights)
    ps = int(platform_size / horizontal_scale / 2)
    cx, cy = nx // 2, ny // 2
    h[cx - ps:cx + ps, cy - ps:cy + ps] = 0
    return h


def generate_height_field(cfg, seed):
    """The trimesh terrain block of a task config as a float32 numpy field
    in meters, [num_terrains * width_px + 2 border_px, length_px + 2
    border_px]: tiles by terrain_proportions [plane, slope, random,
    discrete] inside a flat border."""
    rng = np.random.default_rng(seed)
    hs, vs = cfg["horizontal_scale"], cfg["vertical_scale"]
    bp = int(cfg["border_size"] / hs)
    wpx = int(cfg["terrain_width"] / hs)
    lpx = int(cfg["terrain_length"] / hs)
    raw = np.zeros((cfg["num_terrains"] * wpx + 2 * bp, lpx + 2 * bp), dtype=np.float64)
    props = np.asarray(cfg["terrain_proportions"], dtype=np.float64)
    cum = cfg["num_terrains"] * np.cumsum(props) / props.sum()
    for i in range(cfg["num_terrains"]):
        tile = np.zeros((wpx, lpx))
        if i < cum[0]:
            pass
        elif i < cum[1]:
            _pyramid_sloped(tile, cfg["slope"], hs, vs)
        elif i < cum[2]:
            _random_uniform(tile, rng, -0.5 * cfg["random_height"],
                            0.5 * cfg["random_height"], 0.005, 0.2, hs, vs)
        else:
            _discrete_obstacles(tile, rng, cfg["discrete_height"], 1.0, 2.0, 20, hs, vs)
        raw[bp + i * wpx: bp + (i + 1) * wpx, bp: bp + lpx] = tile
    return (raw * vs).astype(np.float32)


class Terrain:
    """Static terrain shared by all envs; the field lives on `device`.
    Hot paths pass the field explicitly (hf=...), as the JAX package does."""

    def __init__(self, cfg, seed=0, device="cpu"):
        self.type = cfg["type"]
        self.static_friction = float(cfg.get("static_friction", 1.0))
        self.restitution = float(cfg.get("restitution", 0.0))
        if self.type == "plane":
            self.height_field = None
            return
        if self.type != "trimesh":
            raise ValueError(f"Invalid terrain type: {self.type}")
        self.horizontal_scale = cfg["horizontal_scale"]
        self.vertical_scale = cfg["vertical_scale"]
        self.border_size = cfg["border_size"]
        self.env_width = cfg["num_terrains"] * cfg["terrain_width"]
        self.env_length = cfg["terrain_length"]
        self.border_pixels = int(self.border_size / self.horizontal_scale)
        self.height_field = torch.as_tensor(generate_height_field(cfg, seed), device=device)
        # a tensor divisor keeps x / hs a true division on a GPU too, where
        # a Python scalar divisor becomes a multiplication by 1 / hs
        self._hs = torch.full((1,), self.horizontal_scale, dtype=torch.float32, device=device)

    def _cell(self, xy, hf):
        """Cell fractions and the four corner heights around world xy,
        clamped to the whole field."""
        hf = self.height_field if hf is None else hf
        x = self.border_pixels + xy[..., 0] / self._hs
        y = self.border_pixels + xy[..., 1] / self._hs
        x = torch.clamp(x, 0.0, hf.shape[0] - 1.001)
        y = torch.clamp(y, 0.0, hf.shape[1] - 1.001)
        x1, y1 = torch.floor(x), torch.floor(y)
        fx, fy = x - x1, y - y1
        x1, y1 = x1.long(), y1.long()
        return fx, fy, hf[x1, y1], hf[x1 + 1, y1], hf[x1, y1 + 1], hf[x1 + 1, y1 + 1]

    @staticmethod
    def _height(fx, fy, h11, h21, h12, h22):
        return ((1 - fx) * (1 - fy) * h11 + fx * (1 - fy) * h21
                + (1 - fx) * fy * h12 + fx * fy * h22)

    def _normal(self, fx, fy, h11, h21, h12, h22):
        dhdx = ((1 - fy) * (h21 - h11) + fy * (h22 - h12)) / self._hs
        dhdy = ((1 - fx) * (h12 - h11) + fx * (h22 - h21)) / self._hs
        n = torch.stack([-dhdx, -dhdy, torch.ones_like(dhdx)], dim=-1)
        return n / torch.linalg.norm(n, dim=-1, keepdim=True)

    @staticmethod
    def _up(xy):
        n = torch.zeros(xy.shape[:-1] + (3,), dtype=torch.float32, device=xy.device)
        n[..., 2] = 1.0
        return n

    def heights(self, xy, hf=None):
        """Bilinear terrain height at world xy [..., 2] -> [...]."""
        if self.height_field is None:
            return torch.zeros(xy.shape[:-1], dtype=torch.float32, device=xy.device)
        return self._height(*self._cell(xy, hf))

    def normals(self, xy, hf=None):
        """Unit normal of the bilinear patch at world xy [..., 2] -> [..., 3]."""
        if self.height_field is None:
            return self._up(xy)
        return self._normal(*self._cell(xy, hf))

    def heights_and_normals(self, xy, hf=None):
        """Height and normal from one read of the four corners."""
        if self.height_field is None:
            return self.heights(xy), self._up(xy)
        cell = self._cell(xy, hf)
        return self._height(*cell), self._normal(*cell)
