// K6 + K7's per-query body: the terrain height and unit normal under one
// query point, as the JAX package's sampler returns them.  Two device
// functions (an env's patch origin, then a query on the patch), included by
// the standalone sampler (terrain_sample.cu) and by the control-step
// kernel's epilogue (substep.cu), so both compute the same bits for the
// same query.
//
// The reference (booster_gym_tpu/terrain/sample_kernel.py) reads a [24, 24]
// patch of the field around each env's root and clamps every query inside
// it:
//   - the patch origin: rows ox = 8-aligned clip(floor(rx) - 7, 0, Rp - 24)
//     with Rp = R rounded up to 8, columns 8 * (clip(floor(ry) - 7, 0,
//     8 (S - 1)) / 8) with S = max(1, max(0, C - 17) / 8 + 1);
//   - a query is clamped inside its env's patch, [0, 24 - 1.001] both ways,
//     so a point farther than ~0.7 m from its root reads the patch border;
//   - rows and columns past the field's edge read the edge value.
// Grid coordinates are bp + x / hs with a true division: a reciprocal could
// move floor() across a cell line, where the slopes jump.  Every floating-
// point operation is an _rn intrinsic, which nvcc neither contracts into an
// FMA nor reorders: two translation units cannot round it differently.  The
// order of the operations is the plain version's
// (terrain/sample_kernel.py::TerrainSampler.plain); only the normal's scale
// differs (a reciprocal square root times each component against a division
// by the norm), within the reference's 2e-5.

#ifndef BG_TERRAIN_SAMPLE_CUH
#define BG_TERRAIN_SAMPLE_CUH

#define PX 24   // patch rows and columns the reference consumes

// the origin (ox, oy) of the patch of an env whose root is at (root_x,
// root_y), in grid rows and columns (float -> int conversion saturates;
// NaN gives 0)
__device__ __forceinline__ void terrain_patch(int R, int C, float bp, float hs, float root_x,
                                              float root_y, int* ox, int* oy) {
  const int Rp = (R + 7) / 8 * 8;
  const int S = max(1, max(0, C - 17) / 8 + 1);
  const float rx = __fadd_rn(bp, __fdiv_rn(root_x, hs));
  const float ry = __fadd_rn(bp, __fdiv_rn(root_y, hs));
  *ox = min(max((int)floorf(rx) - 7, 0), Rp - PX) / 8 * 8;
  *oy = min(max((int)floorf(ry) - 7, 0), 8 * (S - 1)) / 8 * 8;
}

// height h and unit normal n of field hf [R, C] (row-major, f32) under the
// query (x, y), clamped inside the patch at (ox, oy)
__device__ __forceinline__ void terrain_sample_at(const float* __restrict__ hf, int R, int C,
                                                  float bp, float hs, int ox, int oy, float x,
                                                  float y, float* h, float* n) {
  const float pmax = (float)(PX - 1.001);
  const float gx = __fadd_rn(bp, __fdiv_rn(x, hs));
  const float gy = __fadd_rn(bp, __fdiv_rn(y, hs));
  const float px = fminf(fmaxf(__fsub_rn(gx, (float)ox), 0.0f), pmax);
  const float py = fminf(fmaxf(__fsub_rn(gy, (float)oy), 0.0f), pmax);
  const float x1 = floorf(px), y1 = floorf(py);
  const float fx = __fsub_rn(px, x1), fy = __fsub_rn(py, y1);
  const float gfx = __fsub_rn(1.0f, fx), gfy = __fsub_rn(1.0f, fy);
  const int ix = ox + (int)x1, iy = oy + (int)y1;
  const int r0 = min(ix, R - 1), r1 = min(ix + 1, R - 1);
  const int c0 = min(iy, C - 1), c1 = min(iy + 1, C - 1);
  const float h11 = hf[r0 * C + c0], h21 = hf[r1 * C + c0];
  const float h12 = hf[r0 * C + c1], h22 = hf[r1 * C + c1];

  // ((1 - fx)(1 - fy) h11 + fx (1 - fy) h21) + (1 - fx) fy h12 + fx fy h22
  *h = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(gfx, gfy), h11),
                                     __fmul_rn(__fmul_rn(fx, gfy), h21)),
                           __fmul_rn(__fmul_rn(gfx, fy), h12)),
                 __fmul_rn(__fmul_rn(fx, fy), h22));
  const float dhdx = __fdiv_rn(__fadd_rn(__fmul_rn(gfy, __fsub_rn(h21, h11)),
                                         __fmul_rn(fy, __fsub_rn(h22, h12))), hs);
  const float dhdy = __fdiv_rn(__fadd_rn(__fmul_rn(gfx, __fsub_rn(h12, h11)),
                                         __fmul_rn(fx, __fsub_rn(h22, h21))), hs);
  const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(
      __fadd_rn(__fmul_rn(dhdx, dhdx), __fmul_rn(dhdy, dhdy)), 1.0f)));
  n[0] = __fmul_rn(-dhdx, inv);
  n[1] = __fmul_rn(-dhdy, inv);
  n[2] = inv;
}

#endif  // BG_TERRAIN_SAMPLE_CUH
