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
// normal, with the reference's patch clamps (terrain_sample.cuh, which the
// control-step kernel's epilogue in substep.cu includes too: on the env's
// path the sampling runs there, and this kernel is its standalone form).
// The plain PyTorch version is terrain/sample_kernel.py::TerrainSampler.plain.
//
// What bounds it on an H100 (SXM, 3.35 TB/s): bytes.  Per env it reads the
// root (8 B) and N queries (8 B each) and writes N heights and normals
// (16 B each); at N = 65 and 4096 envs 6.4 MB, plus the 0.72 MB field of
// T1.yaml, which stays in the 50 MB L2: about 2.1 us.  Its arithmetic is
// ~50 f32 operations per query.  Threads are laid along [B, N], so loads of
// the queries and stores of the heights are contiguous; the corner reads
// are a gather and the normals are stored with a stride of 3 floats.

#include <cuda_runtime.h>

#include "terrain_sample.cuh"

#define BLOCK 256

__global__ void __launch_bounds__(BLOCK)
terrain_sample_kernel(const float* __restrict__ hf, const float* __restrict__ root_xy,
                      const float* __restrict__ pts_xy, float* __restrict__ h_out,
                      float* __restrict__ n_out, int B, int N, int R, int C, float bp,
                      float hs) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * N) return;
  const int e = t / N;
  int ox, oy;
  terrain_patch(R, C, bp, hs, root_xy[2 * e], root_xy[2 * e + 1], &ox, &oy);
  float n[3];
  terrain_sample_at(hf, R, C, bp, hs, ox, oy, pts_xy[2 * t], pts_xy[2 * t + 1], &h_out[t], n);
  n_out[3 * t] = n[0];
  n_out[3 * t + 1] = n[1];
  n_out[3 * t + 2] = n[2];
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
