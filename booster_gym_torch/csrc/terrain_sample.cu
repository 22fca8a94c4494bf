// K6 + K7: the terrain sampler, one kernel for Hopper (sm_90a).
//
// Replaces the two TPU kernels of booster_gym_tpu/terrain/sample_kernel.py:
// `stage_kernel` (line 83, launched at line 123), which copies a [24, 128]
// patch of a pre-sheared table around each env's root, and
// `_make_compute_kernel.kernel` (line 181, launched at line 151), which
// takes the bilinear height and both slopes of every query point on that
// patch.  The pre-sheared table and the patch copy exist because a TPU DMA
// spans whole 128-lane tiles; here one thread per (env, query) reads the
// four corners straight from the field and writes the height and the unit
// normal.  The result is the reference's for every input, the clamped ones
// included:
//   - the patch origin: rows ox = 8-aligned clip(floor(rx) - 7, 0, Rp - 24)
//     with Rp = R rounded up to 8, columns 8 * (clip(floor(ry) - 7, 0,
//     8 (S - 1)) / 8) with S = max(1, max(0, C - 17) / 8 + 1);
//   - a query is clamped inside its env's patch, [0, 24 - 1.001] both ways,
//     so a point farther than ~0.7 m from its root reads the patch border;
//   - rows and columns past the field's edge read the edge value.
// Grid coordinates are bp + x / hs with a true division (no fast math): a
// reciprocal could move floor() across a cell line, where the slopes jump.
// The plain PyTorch version is terrain/sample_kernel.py::sample_plain.
//
// What bounds it on an H100 (SXM, 3.35 TB/s): bytes.  Per env it reads the
// root (8 B) and N queries (8 B each) and writes N heights and normals
// (16 B each); at N = 65 and 4096 envs 6.4 MB, plus the 0.72 MB field of
// T1.yaml, which stays in the 50 MB L2: about 2.1 us.  Its arithmetic is
// ~50 f32 operations per query.  Threads are laid along [B, N], so loads of
// the queries and stores of the heights are contiguous; the corner reads
// are a gather and the normals are stored with a stride of 3 floats.

#include <cuda_runtime.h>

#define PX 24   // patch rows and columns the reference consumes
#define BLOCK 256

__global__ void __launch_bounds__(BLOCK)
terrain_sample_kernel(const float* __restrict__ hf, const float* __restrict__ root_xy,
                      const float* __restrict__ pts_xy, float* __restrict__ h_out,
                      float* __restrict__ n_out, int B, int N, int R, int C, float bp,
                      float hs) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * N) return;
  const int e = t / N;
  const int Rp = (R + 7) / 8 * 8;
  const int S = max(1, max(0, C - 17) / 8 + 1);
  const float pmax = (float)(PX - 1.001);

  // the env's patch origin (float -> int conversion saturates; NaN gives 0)
  const float rx = bp + root_xy[2 * e] / hs;
  const float ry = bp + root_xy[2 * e + 1] / hs;
  int ox = min(max((int)floorf(rx) - 7, 0), Rp - PX);
  ox = ox / 8 * 8;
  int oy = min(max((int)floorf(ry) - 7, 0), 8 * (S - 1));
  oy = oy / 8 * 8;

  // the query, clamped inside the patch
  const float gx = bp + pts_xy[2 * t] / hs;
  const float gy = bp + pts_xy[2 * t + 1] / hs;
  const float px = fminf(fmaxf(gx - (float)ox, 0.0f), pmax);
  const float py = fminf(fmaxf(gy - (float)oy, 0.0f), pmax);
  const float x1 = floorf(px), y1 = floorf(py);
  const float fx = px - x1, fy = py - y1;
  const int ix = ox + (int)x1, iy = oy + (int)y1;
  const int r0 = min(ix, R - 1), r1 = min(ix + 1, R - 1);
  const int c0 = min(iy, C - 1), c1 = min(iy + 1, C - 1);
  const float h11 = hf[r0 * C + c0], h21 = hf[r1 * C + c0];
  const float h12 = hf[r0 * C + c1], h22 = hf[r1 * C + c1];

  h_out[t] = (1.0f - fx) * (1.0f - fy) * h11 + fx * (1.0f - fy) * h21
             + (1.0f - fx) * fy * h12 + fx * fy * h22;
  const float dhdx = ((1.0f - fy) * (h21 - h11) + fy * (h22 - h12)) / hs;
  const float dhdy = ((1.0f - fx) * (h12 - h11) + fx * (h22 - h21)) / hs;
  const float inv = 1.0f / sqrtf(dhdx * dhdx + dhdy * dhdy + 1.0f);
  n_out[3 * t] = -dhdx * inv;
  n_out[3 * t + 1] = -dhdy * inv;
  n_out[3 * t + 2] = inv;
}

// Plain C entry point for ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it never synchronizes.
extern "C" int bg_terrain_sample(const float* hf, const float* root_xy, const float* pts_xy,
                                 float* h_out, float* n_out, int B, int N, int R, int C,
                                 float bp, float hs, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const int grid = (B * N + BLOCK - 1) / BLOCK;
  terrain_sample_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(hf, root_xy, pts_xy, h_out,
                                                                  n_out, B, N, R, C, bp, hs);
  return (int)cudaGetLastError();
}
