"""K6 + K7: the terrain sampler as one hand-written CUDA kernel.

One call per control step answers every terrain query of the step (contact
points, root, foot edges): the bilinear height and the unit normal of the
field under each query point.  csrc/terrain_sample.cu replaces the JAX
package's two Pallas kernels (terrain/sample_kernel.py: the patch staging
and the one-hot bilinear); this module wraps it and keeps the plain PyTorch
version beside it.

Both return what the JAX sampler returns for every input.  That sampler
reads a [24, 24] patch of the field around each env's root, 8-aligned both
ways, and clamps each query inside its env's patch: a point farther than
~0.7 m from its root reads the patch border, not the field under it
(Terrain.heights clamps to the whole field instead).  Rows and columns past
the field's edge read the edge value.

The wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""

import ctypes

import torch

from booster_gym_torch import kernel_build

SOURCE = "terrain_sample.cu"
PX = 24   # patch rows and columns the reference consumes


class TerrainSampler:
    """sample(hf [R, C], root_xy [B, 2], pts_xy [B, N, 2]) ->
    (h [B, N], n [B, N, 3]), all f32.

    `launches` counts kernel launches; it moves only where the CUDA kernel
    is launched."""

    def __init__(self, terrain, num_points, device):
        if terrain.height_field is None:
            raise ValueError("the terrain sampler needs a heightfield terrain")
        self.hs = float(terrain.horizontal_scale)
        self.bp = float(terrain.border_pixels)
        self.num_points = int(num_points)
        self._hs = torch.full((1,), self.hs, dtype=torch.float32, device=device)
        self.launches = 0
        self._lib = None

    def plain(self, hf, root_xy, pts_xy):
        """The same function as gathers on the field, with the patch clamps."""
        R, C = hf.shape
        Rp = -(-R // 8) * 8
        S = max(1, max(0, C - 17) // 8 + 1)
        # a tensor divisor: a true division, as the kernel's
        rx = self.bp + root_xy[..., 0] / self._hs
        ry = self.bp + root_xy[..., 1] / self._hs
        ox = torch.clamp(torch.floor(rx).long() - 7, 0, Rp - PX) // 8 * 8
        oy = torch.clamp(torch.floor(ry).long() - 7, 0, 8 * (S - 1)) // 8 * 8
        gx = self.bp + pts_xy[..., 0] / self._hs
        gy = self.bp + pts_xy[..., 1] / self._hs
        px = torch.clamp(gx - ox[:, None].float(), 0.0, PX - 1.001)
        py = torch.clamp(gy - oy[:, None].float(), 0.0, PX - 1.001)
        x1, y1 = torch.floor(px), torch.floor(py)
        fx, fy = px - x1, py - y1
        ix, iy = ox[:, None] + x1.long(), oy[:, None] + y1.long()
        r0, r1 = ix.clamp(max=R - 1), (ix + 1).clamp(max=R - 1)
        c0, c1 = iy.clamp(max=C - 1), (iy + 1).clamp(max=C - 1)
        h11, h21, h12, h22 = hf[r0, c0], hf[r1, c0], hf[r0, c1], hf[r1, c1]
        h = ((1 - fx) * (1 - fy) * h11 + fx * (1 - fy) * h21
             + (1 - fx) * fy * h12 + fx * fy * h22)
        dhdx = ((1 - fy) * (h21 - h11) + fy * (h22 - h12)) / self._hs
        dhdy = ((1 - fx) * (h12 - h11) + fx * (h22 - h21)) / self._hs
        n = torch.stack([-dhdx, -dhdy, torch.ones_like(dhdx)], dim=-1)
        return h, n / torch.linalg.norm(n, dim=-1, keepdim=True)

    def build(self):
        """Build (if needed) and load the library; returns nvcc's report."""
        path, report = kernel_build.build(SOURCE, {})
        v, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self._lib = kernel_build.load(path, {
            "bg_terrain_sample": [v, v, v, v, v, i, i, i, i, f, f, v]})
        return report

    def __call__(self, hf, root_xy, pts_xy):
        if hf.device.type == "cpu":
            return self.plain(hf, root_xy, pts_xy)
        if hf.device.type != "cuda":
            raise ValueError(f"no terrain sampler for device {hf.device}")
        if hf.dim() != 2:
            raise ValueError(f"the height field must be [R, C], got {tuple(hf.shape)}")
        B, N = root_xy.shape[0], self.num_points
        for name, t, shape in (("height field", hf, tuple(hf.shape)), ("root_xy", root_xy, (B, 2)),
                               ("pts_xy", pts_xy, (B, N, 2))):
            if t.device != self._hs.device:
                raise ValueError(f"{name} is on {t.device}, the sampler on {self._hs.device}")
            if t.dtype != torch.float32:
                raise ValueError(f"{name} must be float32, got {t.dtype}")
            if tuple(t.shape) != shape:
                raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if self._lib is None:
            self.build()
        h = torch.empty((B, N), dtype=torch.float32, device=hf.device)
        n = torch.empty((B, N, 3), dtype=torch.float32, device=hf.device)
        stream = torch.cuda.current_stream(hf.device).cuda_stream
        err = self._lib.bg_terrain_sample(
            hf.data_ptr(), root_xy.data_ptr(), pts_xy.data_ptr(), h.data_ptr(), n.data_ptr(),
            B, N, hf.shape[0], hf.shape[1], self.bp, self.hs, stream)
        if err != 0:
            raise RuntimeError(f"terrain sampler launch failed: cudaError {err}")
        self.launches += 1
        return h, n


def make_terrain_sampler(terrain, num_points, device):
    """The JAX package's constructor name for TerrainSampler."""
    return TerrainSampler(terrain, num_points, device)
