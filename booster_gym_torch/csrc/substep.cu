// K1 and K5: the physics substep for Hopper (sm_90a), one warp per env.  One
// source, two builds: -DPLANE=1 (the default) is K1, the plane-terrain
// substep; -DPLANE=0 is K5, the general-terrain substep.  Each build has two
// entry points: bg_substep[_terrain] runs one substep, bg_control[_terrain]
// runs a whole control step (the env's decimation loop: delay latch, PD,
// Coulomb joint friction, torque clip, push on substep 0, then the substep,
// `decimation` times) in one launch, with the state on chip throughout.
//
// Replaces the TPU kernel booster_gym_tpu/physics/pallas_engine.py ::
// make_substep_pallas(model, cfg, feet_indices, plane=...), inner `kernel`
// (lines 267-720, launched at line 811): K1 its plane=True specialization,
// K5 its plane=False branches (lines 507-512, 596-606, 636-664, 715-720);
// bg_control replaces the scan of booster_gym_tpu/envs/t1.py::_packed_inner
// (lines 439-502) around it.  Same steps in the same order:
//   1. FK down the static tree;
//   2. spatial inertias about the base origin;
//   3. CRBA mass matrix plus the diagonal regularizer;
//   4. Cholesky inverse with a reciprocal square root per pivot;
//   5. RNEA bias and the free (contact-less) velocity;
//   6. per-body Delassus operators Lambda_b = J_b M^-1 J_b^T;
//   7. per-point 3x3 Delassus blocks, split by the body's active points,
//      closed-form inverses, pushout and restitution targets;
//   8. Jacobi sweeps with the friction cone about the terrain normal;
//   9. quaternion-exponential integration and joint-limit projection;
//  10. feet poses from the start-of-substep FK.
// K5 takes a terrain height h [NPT, B] and a unit normal n [3 NPT, B] per
// contact point (bg_control_terrain: at any element strides), constant over
// the substep (over the control step in bg_control): the depth is h +
// radius - z, the approach speed and the push-out target lie along n, the
// friction cone opens about n, and the points' world xy from step 1's FK
// go out as ptxy [2 NPT, B] for the caller's next terrain query.  K1 is the same code with h = 0 and n = +z
// as compile-time constants.  Every operation into which h or n enters, and
// every sum that consumes one of them, is written with the _rn intrinsics,
// which nvcc neither contracts into FMAs nor reorders, so the compiler
// cannot round the two builds differently; on plane inputs the general
// formulas reduce to the plane ones by exact multiplications by 0 and 1, and
// chip_smoke.py holds the two builds to a difference of 0 there.  All
// arithmetic is f32.  The plain PyTorch version of the same function is
// booster_gym_torch/physics/engine.py::make_substep (its `step` for K1, its
// `step.terrain_form` for K5), and SubstepKernel.control_step_plain for
// bg_control.
//
// The control step's epilogue (control_kernel, after the last substep)
// replaces the env's post-physics tensor ops and the terrain sampler's
// launch (K6 + K7, booster_gym_tpu/terrain/sample_kernel.py), which read
// what the kernel already holds on chip at its end.  Both builds: the foot
// edge points in the world frame, p_f + R_f e_k for each foot f and each
// of NE offsets e_k (a table passed in), in envs/t1.py's operation order,
// every operation an _rn intrinsic, so the points equal the torch ops'
// bitwise and K5 = K1 on plane inputs holds for them as for every output.
// K5 also samples the terrain under the step's NQ = NPT + 1 + NF NE queries
// (the contact points' xy from the last substep's FK, the root, the edge
// points; t1.py's order) with terrain_sample.cuh, the standalone sampler's
// own device functions, and writes heights [B, NQ] and normals [B, NQ, 3],
// the standalone sampler's layout, env-major so that a warp's stores are
// contiguous: the next control step reads their first NPT columns in place
// (strides he = NQ, ne = 3 NQ).  The contact points' xy are recomputed from
// the last substep's FK, which w still holds, by the same device function
// (point_world): bit for bit the ptxy that substep wrote, without reading
// it back.  On an NVIDIA H100 80GB HBM3 at 700 W the epilogue costs K5
// 12-20 us a control step, two thirds of it by being compiled in at all
// (PERF.md, section 6).
// -DEPILOGUE=0 compiles the epilogue out (its outputs are then not
// written): a diagnostic build that times the control step without it.
//
// Design.  A warp per env and EPB envs per block (picked from the robot's
// sizes, below EnvWS; at T1's widths 8, so that 4 blocks of 56.7 KB and 64
// registers a thread put 32 warps on each SM and 4096 envs in one wave of
// 132 SMs).  The block
// copies the robot's table (parent, joint frames and axes, ancestor mask,
// dof limits, contact points, feet, tree levels, points grouped by body,
// solver constants; layout in model_tables() of physics/substep_kernel.py)
// into shared memory once, its index blocks converted to ints.  Each env
// keeps its state, dyn, body and matrix working set in shared memory
// (struct EnvWS, whose phase scratch the phases share); each contact point
// belongs to one lane (point p on lane p % 32, slot p / 32) and keeps its
// lever arm, Delassus inverse, friction, target and impulse in registers,
// and on K5 its h and n, loaded once per launch.  The phases run lanes over
// independent work: (body of a tree level, matrix entry) for FK and
// Lambda's recursion down the tree, bodies for the inertias, (body,
// component) for the body velocities, accelerations and subtree sums
// (sums over the ancestor mask, not walks of the tree), lower-triangle
// pairs for M and G, rows of a column for the Cholesky factor, columns of a
// row for L^-1, points for the Delassus blocks and the sweeps, rows for
// G s.  __syncwarp() separates the phases.  Every cross-lane sum has a
// fixed order (one lane sums its terms in index order), so a launch
// repeats bitwise; there is no atomic.  The sizes NB, ND, NPT, NS, NF are
// -D constants: nothing assumes NPT <= 32 or NV <= 32.
//
// What bounds it on an H100 (SXM, 3.35 TB/s, 67 TFLOP/s f32 outside the
// tensor cores).  Per env and substep at the T1 widths (nb 13, nd 12, npt
// 56, ns 7, nf 2) K1 reads 199 floats and writes 100 (1196 bytes, 4.9 MB at
// 4096 envs, 1.46 us) and does ~5.8e4 f32 operations (chip_smoke.py counts
// them from the loop trip counts; 2.4e8 at 4096 envs, 3.5 us): the
// operations bound it.  A control step of 10 substeps moves the state,
// dyn, the targets and gains once (control_bytes in chip_smoke.py) and does
// ten substeps' operations, so it is bound by operations at ten times 3.5
// us.  What holds it is each warp's chain of dependent shared-memory loads,
// shuffles and __syncwarp()s: one warp alone on an SM takes most of the
// time that 32 take (PERF.md, section 6).

#include <cuda_runtime.h>

#include "terrain_sample.cuh"

#if !defined(NB) || !defined(ND) || !defined(NPT) || !defined(NS) || !defined(NF)
#error "compile with -DNB=.. -DND=.. -DNPT=.. -DNS=.. -DNF=.."
#endif

#ifndef PLANE
#define PLANE 1
#endif
#ifndef PHASE_CLOCKS
#define PHASE_CLOCKS 0
#endif
#ifndef NE
#define NE 0    // foot edge points per foot
#endif
#ifndef EPILOGUE
#define EPILOGUE 1
#endif

#define NV (6 + ND)
#define NSTATE (13 + 2 * ND)
#define NDYN (10 * NB + 2 * NS)
#define PPL ((NPT + 31) / 32)   // contact points per lane
#define NEDGE (NF * NE)          // foot edge points
#define NQ (NPT + 1 + NEDGE)     // terrain queries of a control step
#define QPL ((NQ + 31) / 32)     // queries per lane
#define DPL ((ND + 31) / 32)    // dofs per lane
#define RPL ((NV + 31) / 32)    // matrix rows per lane
#define LDG (NV | 1)            // odd row strides: no bank conflicts
#define LDM ((NV + 1) | 1)
#define NPAIR (NV * (NV + 1) / 2)
#define FULL 0xffffffffu

// model table offsets (must match physics/substep_kernel.py::model_tables)
#define OFF_PARENT 0
#define OFF_JPOS (OFF_PARENT + NB)
#define OFF_JROT (OFF_JPOS + 3 * NB)
#define OFF_JAXIS (OFF_JROT + 9 * NB)
#define OFF_ANC (OFF_JAXIS + 3 * NB)
#define OFF_LO (OFF_ANC + NB * ND)
#define OFF_HI (OFF_LO + ND)
#define OFF_PBODY (OFF_HI + ND)
#define OFF_PSHAPE (OFF_PBODY + NPT)
#define OFF_PPOS (OFF_PSHAPE + NPT)
#define OFF_PRAD (OFF_PPOS + 3 * NPT)
#define OFF_FEET (OFF_PRAD + NPT)
#define OFF_ORDER (OFF_FEET + NF)
#define OFF_LSTART (OFF_ORDER + NB)
#define OFF_BPSTART (OFF_LSTART + NB + 1)
#define OFF_BPLIST (OFF_BPSTART + NB + 1)
#define OFF_PSLOT (OFF_BPLIST + NPT)
#define OFF_CFG (OFF_PSLOT + NPT)
#define MDL_LEN (OFF_CFG + 14)
// solver constants at OFF_CFG + k
#define CFG_DT 0
#define CFG_GX 1
#define CFG_GY 2
#define CFG_GZ 3
#define CFG_ITERS 4
#define CFG_MARGIN 5
#define CFG_BAUMGARTE 6
#define CFG_MAX_PUSHOUT 7
#define CFG_SLOP 8
#define CFG_BOUNCE 9
#define CFG_RELAX 10
#define CFG_TFRIC 11
#define CFG_TREST 12
#define CFG_REG 13

#define MAXI(a, b) ((a) > (b) ? (a) : (b))
// offsets in EnvWS's phase scratch: acc after both the RNEA's accelerations
// and the sweeps' point and body wrenches; vb after acc and Lambda
#define ACC_OFF MAXI(12 * NB, 6 * NPT + 6 * NB)
#define VB_OFF MAXI(36 * NB + 6 * ND, ACC_OFF + 6 * NB)

// One env's working set in shared memory.  Spatial 6-vectors are
// [angular; linear]: velocities [w; v], wrenches [torque; force].
struct EnvWS {
  float st[NSTATE];                 // p0(3) quat(4) v0(3) w0(3) q(ND) qd(ND)
  float dyn[NDYN];
  float ext[6];                     // force, torque at the base origin
  float tau[ND];
  float R[NB][9], P[NB][3];         // world pose of every body
  float phw[ND][3], phv[ND][3];     // joint motion columns at the base origin
  float sb[NB], hb[NB][3], Ab[NB][6];  // spatial inertias (mass, m c, A)
  float G[NV][LDG];                 // M^-1
  float uf[NV], un[NV], sv[NV];     // free velocity, velocity, gen. force
  float cnt[NB];                    // active points per body
  float pact[NPT];
  union {                           // phase scratch; the comments say when
    struct {                        // 1. FK
      float sn[ND], c1[ND];         // sin q, 1 - cos q
      float rod[ND][9];             // each joint's rotation about its axis
    } fk;
    struct {                        // 3-4. CRBA and the inverse
      float sc[NB], hc[NB][3], Ac[NB][6];  // composite inertias
      float F[ND][6];                      // composite inertia x joint column
      float M[NV][LDM];  // M lower; then L below the diagonal, 1/L_ii on it,
                         // and L^-1 transposed above it (L^-1[j][i] at [i][j+1])
    } m;
    struct {                        // 5. RNEA
      float c[NB][6];               // velocity-product terms per joint
      float a[NB][6];               // accelerations, then body forces
    } r;
    struct {                        // 6-7. Delassus operators
      float Lam[NB][36];            // per body
      float x[ND][6];               // (J_p G)[:, 6 + j] per joint
    } l;
    struct {                        // 8. sweeps
      float pw[NPT][6];             // point wrenches, grouped by body
      float wb[NB][6];              // per-body contact wrench (forces out)
    } sw;
    struct {                        // 5 and 8: subtree sums
      float pad[ACC_OFF];
      float acc[NB][6];
    } ac;
    struct {                        // 5, 7 and 8: body velocities
      float pad[VB_OFF];
      float vb[NB][6];
    } v;
  } s;
};

// The launch shape follows the robot.  EPB, the envs (warps) per block, is
// the one of 1..8 whose block fits the H100's 227 KB a block and that keeps
// the most warps resident on an SM (at most 32, so that ptxas is never
// asked for fewer than 64 registers a thread; ties go to the larger EPB).
// MINB, the resident blocks per SM asked of ptxas, is what an SM's 228 KB
// hold at that size, with the 1 KB the card reserves per block.  T1's
// widths give 8 and 4 (56.7 KB a block); the 23-DoF serial robot's ~13 KB
// working sets 7 or 8 and 2.  -DEPB and -DMINB override them (variant
// builds); bg_substep_info reports both.
constexpr int SMEM_BLOCK_MAX = 232448, SMEM_SM = 233472, SMEM_RESERVED = 1024;
constexpr int smem_bytes(int epb) { return (MDL_LEN + NPAIR) * 4 + epb * (int)sizeof(EnvWS); }
constexpr int sm_blocks(int epb) {
  return smem_bytes(epb) > SMEM_BLOCK_MAX
             ? 0
             : (SMEM_SM / (smem_bytes(epb) + SMEM_RESERVED) < 32 / epb
                    ? SMEM_SM / (smem_bytes(epb) + SMEM_RESERVED)
                    : 32 / epb);
}
constexpr int pick_epb() {
  int best = 0;
  for (int epb = 1; epb <= 8; ++epb)
    if (sm_blocks(epb) > 0 && (best == 0 || epb * sm_blocks(epb) >= best * sm_blocks(best)))
      best = epb;
  return best;
}
#ifndef EPB
constexpr int EPB_PICKED = pick_epb();
#define EPB EPB_PICKED
#endif
#ifndef MINB
constexpr int MINB_PICKED = sm_blocks(EPB);
#define MINB MINB_PICKED
#endif
constexpr int SMEM_BYTES = smem_bytes(EPB);
static_assert(EPB >= 1 && SMEM_BYTES <= SMEM_BLOCK_MAX,
              "one env's working set does not fit a block's shared memory");

__device__ __forceinline__ int ti(const float* m, int off) { return __float_as_int(m[off]); }

// Diagnostic builds only (-DPHASE_CLOCKS=1): lane 0 of every warp adds the
// clock cycles of each phase to bg_clk[phase]; bg_substep_clocks reads
// and clears them.  The default build has none of it.
#if PHASE_CLOCKS
#define NCLK 12
__device__ unsigned long long bg_clk[NCLK];
#define CLK(k)                                                     \
  do {                                                             \
    const long long now_ = clock64();                              \
    if ((threadIdx.x & 31) == 0) atomicAdd(&bg_clk[k], now_ - t_clk); \
    t_clk = now_;                                                  \
  } while (0)
#define CLK_START long long t_clk = clock64()
#else
#define CLK(k)
#define CLK_START
#endif

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void cross3(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// o = A @ B for row-major 3x3
__device__ __forceinline__ void mul33(const float* A, const float* B, float* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      o[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

// o = A @ v
__device__ __forceinline__ void mv33(const float* A, const float* v, float* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    o[i] = A[3 * i] * v[0] + A[3 * i + 1] * v[1] + A[3 * i + 2] * v[2];
}

// symmetric 3x3 stored as (00, 01, 02, 11, 12, 22)
__device__ __forceinline__ float s6(const float* A, int i, int j) {
  const int lo = i < j ? i : j, hi = i < j ? j : i;
  return A[lo == 0 ? hi : (lo == 1 ? 2 + hi : 5)];
}

// spatial inertia (s, h, A) applied to [w; v]: [A w + h x v ; -(h x w) + s v]
__device__ __forceinline__ void inertia_apply(float s, const float* h, const float* A,
                                              const float* w, const float* v,
                                              float* top, float* bot) {
  float hxv[3], hxw[3];
  cross3(h, v, hxv);
  cross3(h, w, hxw);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    top[i] = s6(A, i, 0) * w[0] + s6(A, i, 1) * w[1] + s6(A, i, 2) * w[2] + hxv[i];
    bot[i] = -hxw[i] + v[i] * s;
  }
}

__device__ __forceinline__ int swap6(int i) { return i < 3 ? i + 3 : i - 3; }

// the terrain-facing dot product a . n, in a fixed rounding order
__device__ __forceinline__ float dot_n(const float* a, const float* n) {
  return __fmaf_rn(a[2], n[2], __fmaf_rn(a[1], n[1], __fmul_rn(a[0], n[0])));
}

// ---------------------------------------------------------------------------
// Warp routines.  Every one is entered by all 32 lanes of the env's warp and
// leaves the warp synchronised.

// acc[b] = the sum of src[d] over the bodies d of b's subtree, d ascending;
// lanes over (body, component)
__device__ __forceinline__ void subtree_sums(EnvWS& w, const float* m, const float (*src)[6],
                                             int lane) {
  for (int t = lane; t < 6 * NB; t += 32) {
    const int b = t / 6, c = t % 6;
    float acc = 0.0f;
#pragma unroll
    for (int d = 0; d < NB; ++d)   // d in b's subtree: anc[d][b - 1], or b = 0
      acc = fmaf(b == 0 ? 1.0f : m[OFF_ANC + d * ND + b - 1], src[d][c], acc);
    w.s.ac.acc[b][c] = acc;
  }
  __syncwarp();
}

// sv = J^T acc for body wrenches [torque; force] summed by subtree_sums:
// [force; torque] of the whole tree, then phi_j . acc[j + 1]; lanes over rows
__device__ __forceinline__ void gen_force(EnvWS& w, int lane) {
  for (int i = lane; i < NV; i += 32) {
    float v;
    if (i < 3) {
      v = w.s.ac.acc[0][3 + i];
    } else if (i < 6) {
      v = w.s.ac.acc[0][i - 3];
    } else {
      const int j = i - 6;
      v = dot3(w.phw[j], w.s.ac.acc[j + 1]) + dot3(w.phv[j], &w.s.ac.acc[j + 1][3]);
    }
    w.sv[i] = v;
  }
  __syncwarp();
}

// (G x)[i], summed in index order
__device__ __forceinline__ float g_row(const EnvWS& w, int i, const float* x) {
  float acc = w.G[i][0] * x[0];
#pragma unroll
  for (int k = 1; k < NV; ++k) acc += w.G[i][k] * x[k];
  return acc;
}

// body velocities [w; v] from a generalized velocity u = [v0, w0, qd]:
// the base's plus phi_j qd_j over the joints that move the body, j
// ascending; lanes over (body, component).  The masked sums here and below
// multiply by the 0/1 ancestor mask instead of branching on it, so every
// load is independent of the others: x + 0 y = x and x + 1 y = x + y
// exactly.
__device__ __forceinline__ void body_velocities(EnvWS& w, const float* m, const float* u,
                                                int lane) {
  for (int t = lane; t < 6 * NB; t += 32) {
    const int b = t / 6, c = t % 6;
    const float* anc = m + OFF_ANC + b * ND;
    const float* ph = c < 3 ? &w.phw[0][c] : &w.phv[0][c - 3];
    float v = c < 3 ? u[3 + c] : u[c - 3];
#pragma unroll
    for (int j = 0; j < ND; ++j) v = fmaf(anc[j] * ph[3 * j], u[6 + j], v);
    w.s.v.vb[b][c] = v;
  }
  __syncwarp();
}

// the velocity of a point at r on body b (base-origin lever arm)
__device__ __forceinline__ void point_velocity(const EnvWS& w, int b, const float* r, float* v) {
  float wxr[3];
  cross3(w.s.v.vb[b], r, wxr);
#pragma unroll
  for (int k = 0; k < 3; ++k) v[k] = w.s.v.vb[b][3 + k] + wxr[k];
}

// the point impulses' per-body wrenches wb (its force part is the contact
// force), then un = uf + G J^T wb
__device__ __forceinline__ void wrench_du(EnvWS& w, const float* m,
                                          const float (&pr)[PPL][3],
                                          const float (&lam)[PPL][3], int lane) {
#pragma unroll
  for (int s = 0; s < PPL; ++s) {
    const int p = lane + 32 * s;
    if (p < NPT) {   // each body's points sit together, in index order
      float* o = w.s.sw.pw[ti(m, OFF_PSLOT + p)];
      cross3(pr[s], lam[s], o);
#pragma unroll
      for (int k = 0; k < 3; ++k) o[3 + k] = lam[s][k];
    }
  }
  __syncwarp();
  for (int t = lane; t < 6 * NB; t += 32) {   // one lane per (body, component)
    const int b = t / 6, c = t % 6;
    const int z = ti(m, OFF_BPSTART + b + 1);
    float acc = 0.0f;
#pragma unroll 4
    for (int q = ti(m, OFF_BPSTART + b); q < z; ++q) acc += w.s.sw.pw[q][c];
    w.s.sw.wb[b][c] = acc;
  }
  __syncwarp();
  subtree_sums(w, m, w.s.sw.wb, lane);
  gen_force(w, lane);
  for (int i = lane; i < NV; i += 32) w.un[i] = w.uf[i] + g_row(w, i, w.sv);
  __syncwarp();
}

// contact point p's world position from the FK in w: R_b ppos_p + P_b (the
// epilogue recomputes the last substep's this way, bit for bit)
__device__ __forceinline__ void point_world(const EnvWS& w, const float* m, int p,
                                            float (&wp)[3]) {
  const int b = ti(m, OFF_PBODY + p);
  mv33(w.R[b], m + OFF_PPOS + 3 * p, wp);
#pragma unroll
  for (int k = 0; k < 3; ++k) wp[k] += w.P[b][k];
}

// ---------------------------------------------------------------------------
// One substep of one env: w.st and w.tau, w.ext in; w.st, w.s.sw.wb (contact
// wrench per body), w.R and w.P (the start-of-substep FK) out.  ph, pn:
// each lane's points' terrain height and normal (constants 0 and +z on
// K1).  ptxy, when not null, takes the points' world xy.
__device__ __forceinline__ void substep(EnvWS& w, const float* m, const int* pairs, int lane,
                                        const float (&ph)[PPL], const float (&pn)[PPL][3],
                                        float* ptxy, int e, int B) {
  const float* cfg = m + OFF_CFG;
  const float dt = cfg[CFG_DT];
  const float* p0 = w.st;
  const float* q = w.st + 13;
  const float* qd = w.st + 13 + ND;

  CLK_START;
  // ---------------- 1. FK, one tree level at a time ----------------
  // sin q and 1 - cos q per joint, lanes over joints; then each joint's
  // rotation about its constant axis, I + sin(q) K + (1 - cos(q)) K^2,
  // lanes over (joint, entry)
  for (int j = lane; j < ND; j += 32) {
    float c;
    sincosf(q[j], &w.s.fk.sn[j], &c);
    w.s.fk.c1[j] = 1.0f - c;
  }
  if (lane == 0) {
    const float qw = w.st[3], x = w.st[4], y = w.st[5], z = w.st[6];
    float* R0 = w.R[0];
    R0[0] = 1 - 2 * (y * y + z * z); R0[1] = 2 * (x * y - qw * z); R0[2] = 2 * (x * z + qw * y);
    R0[3] = 2 * (x * y + qw * z); R0[4] = 1 - 2 * (x * x + z * z); R0[5] = 2 * (y * z - qw * x);
    R0[6] = 2 * (x * z - qw * y); R0[7] = 2 * (y * z + qw * x); R0[8] = 1 - 2 * (x * x + y * y);
#pragma unroll
    for (int k = 0; k < 3; ++k) w.P[0][k] = p0[k];
  }
  __syncwarp();
  for (int t = lane; t < 9 * ND; t += 32) {
    const int j = t / 9, i = (t % 9) / 3, c = t % 3;
    const float* ax = m + OFF_JAXIS + 3 * (j + 1);
    const float K[9] = {0.0f, -ax[2], ax[1], ax[2], 0.0f, -ax[0], -ax[1], ax[0], 0.0f};
    const float K2 = K[3 * i] * K[c] + K[3 * i + 1] * K[3 + c] + K[3 * i + 2] * K[6 + c];
    w.s.fk.rod[j][3 * i + c] = (i == c ? 1.0f : 0.0f) + w.s.fk.sn[j] * K[3 * i + c] + w.s.fk.c1[j] * K2;
  }
  __syncwarp();
  // down the tree, lanes over (body of the level, entry of R or P)
#pragma unroll 1
  for (int L = 1; L < NB; ++L) {
    const int a = ti(m, OFF_LSTART + L);
    if (a >= NB) break;
    const int n = 12 * (ti(m, OFF_LSTART + L + 1) - a);
    for (int t = lane; t < n; t += 32) {
      const int b = ti(m, OFF_ORDER + a + t / 12), e = t % 12, p = ti(m, OFF_PARENT + b);
      const float* Rp = w.R[p];
      if (e < 9) {   // R_b = (R_p jrot) rod, entry (i, c)
        const int i = e / 3, c = e % 3;
        const float* jrot = m + OFF_JROT + 9 * b;
        const float* rod = w.s.fk.rod[b - 1];
        float jR[3];
#pragma unroll
        for (int k = 0; k < 3; ++k)
          jR[k] = Rp[3 * i] * jrot[k] + Rp[3 * i + 1] * jrot[3 + k] + Rp[3 * i + 2] * jrot[6 + k];
        w.R[b][e] = jR[0] * rod[c] + jR[1] * rod[3 + c] + jR[2] * rod[6 + c];
      } else {       // P_b = P_p + R_p jpos
        const int k = e - 9;
        const float* jp = m + OFF_JPOS + 3 * b;
        w.P[b][k] = w.P[p][k] + (Rp[3 * k] * jp[0] + Rp[3 * k + 1] * jp[1] + Rp[3 * k + 2] * jp[2]);
      }
    }
    __syncwarp();
  }
  // joint motion columns at the base origin: phw = (R_p jrot) axis,
  // phv = (P_b - p0) x phw; lanes over (joint, component)
  for (int t = lane; t < 6 * ND; t += 32) {
    const int j = t / 6, k = t % 6, b = j + 1;
    const float* Rp = w.R[ti(m, OFF_PARENT + b)];
    const float* jrot = m + OFF_JROT + 9 * b;
    const float* ax = m + OFF_JAXIS + 3 * b;
    float jR[9], phw[3];
    mul33(Rp, jrot, jR);
    mv33(jR, ax, phw);
    if (k < 3) {
      w.phw[j][k] = phw[k];
    } else {
      float c[3], v[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) c[i] = w.P[b][i] - p0[i];
      cross3(c, phw, v);
      w.phv[j][k - 3] = v[k - 3];
    }
  }
  __syncwarp();
  CLK(0);
  // ---------------- 2. spatial inertias at the base origin, lanes over bodies
  for (int b = lane; b < NB; b += 32) {
    const float mb = w.dyn[b];
    const float* R = w.R[b];
    float cl[3], cw[3], Il[6], T[9], Im[9];
#pragma unroll
    for (int k = 0; k < 3; ++k) cl[k] = w.dyn[NB + 3 * b + k];
#pragma unroll
    for (int k = 0; k < 6; ++k) Il[k] = w.dyn[4 * NB + 6 * b + k];  // xx yy zz xy xz yz
    mv33(R, cl, cw);
#pragma unroll
    for (int k = 0; k < 3; ++k) cw[k] += w.P[b][k] - p0[k];
    Im[0] = Il[0]; Im[1] = Il[3]; Im[2] = Il[4];
    Im[3] = Il[3]; Im[4] = Il[1]; Im[5] = Il[5];
    Im[6] = Il[4]; Im[7] = Il[5]; Im[8] = Il[2];
    mul33(R, Im, T);
    float Iw[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = i; j < 3; ++j)
        Iw[i][j] = T[3 * i] * R[3 * j] + T[3 * i + 1] * R[3 * j + 1] + T[3 * i + 2] * R[3 * j + 2];
    const float c2 = dot3(cw, cw);
    float* A = w.Ab[b];
    A[0] = Iw[0][0] + mb * (c2 - cw[0] * cw[0]);
    A[1] = Iw[0][1] - mb * cw[0] * cw[1];
    A[2] = Iw[0][2] - mb * cw[0] * cw[2];
    A[3] = Iw[1][1] + mb * (c2 - cw[1] * cw[1]);
    A[4] = Iw[1][2] - mb * cw[1] * cw[2];
    A[5] = Iw[2][2] + mb * (c2 - cw[2] * cw[2]);
    w.sb[b] = mb;
#pragma unroll
    for (int k = 0; k < 3; ++k) w.hb[b][k] = cw[k] * mb;
  }
  __syncwarp();

  // ---------------- 3. CRBA mass matrix ----------------
  // composite inertias: subtree sums, lanes over (body, component)
  for (int t = lane; t < 10 * NB; t += 32) {
    const int b = t / 10, c = t % 10;
    const float* src;
    int stride;
    float* dst;
    if (c == 0) {
      src = w.sb; stride = 1; dst = &w.s.m.sc[b];
    } else if (c < 4) {
      src = &w.hb[0][c - 1]; stride = 3; dst = &w.s.m.hc[b][c - 1];
    } else {
      src = &w.Ab[0][c - 4]; stride = 6; dst = &w.s.m.Ac[b][c - 4];
    }
    float acc = 0.0f;
#pragma unroll
    for (int d = 0; d < NB; ++d)
      acc = fmaf(b == 0 ? 1.0f : m[OFF_ANC + d * ND + b - 1], src[d * stride], acc);
    *dst = acc;
  }
  __syncwarp();
  // each joint column through its subtree's composite inertia, lanes over dofs
  for (int j = lane; j < ND; j += 32)
    inertia_apply(w.s.m.sc[j + 1], w.s.m.hc[j + 1], w.s.m.Ac[j + 1], w.phw[j], w.phv[j],
                  w.s.m.F[j], w.s.m.F[j] + 3);
  __syncwarp();
  // the lower triangle, lanes over (i <= j) pairs; u order [v0, w0, qd];
  // uncoupled pairs are exact zeros
  for (int t = lane; t < NPAIR; t += 32) {
    const int i = pairs[t] >> 16, j = pairs[t] & 0xffff;
    float val;
    if (j < 6) {
      const float* h0 = w.s.m.hc[0];
      if (i >= 3) {
        val = s6(w.s.m.Ac[0], i - 3, j - 3);
      } else if (j < 3) {
        val = i == j ? w.s.m.sc[0] : 0.0f;
      } else {  // -skew(h0)[i][j - 3]
        const int k = j - 3;
        val = i == k ? 0.0f : (i == 0 ? (k == 1 ? h0[2] : -h0[1])
                                      : i == 1 ? (k == 0 ? -h0[2] : h0[0])
                                               : (k == 0 ? h0[1] : -h0[0]));
      }
    } else if (i < 6) {  // v rows take the linear part, w rows the angular part
      val = i < 3 ? w.s.m.F[j - 6][3 + i] : w.s.m.F[j - 6][i - 3];
    } else {
      const int k = i - 6, jj = j - 6;
      val = m[OFF_ANC + (jj + 1) * ND + k] != 0.0f
                ? dot3(w.s.m.F[jj], w.phw[k]) + dot3(w.s.m.F[jj] + 3, w.phv[k]) : 0.0f;
    }
    if (i == j) val += cfg[CFG_REG];
    w.s.m.M[j][i] = val;
  }
  __syncwarp();

  CLK(1);
  // ---------------- 4. Cholesky inverse ----------------
  // L column by column, lanes over the rows at and below the pivot; the
  // pivot's row sits on lane 0, which hands 1/sqrt of it to the others
  float (*M)[LDM] = w.s.m.M;
#pragma unroll 1
  for (int i = 0; i < NV; ++i) {
    float t[RPL];
#pragma unroll
    for (int r = 0; r < RPL; ++r) {
      const int j = i + lane + 32 * r;
      t[r] = 1.0f;
      if (j < NV) {
        float s = M[j][i];
#pragma unroll 4
        for (int k = 0; k < i; ++k) s -= M[j][k] * M[i][k];
        t[r] = s;
      }
    }
    const float d = __shfl_sync(FULL, rsqrtf(t[0]), 0);
#pragma unroll
    for (int r = 0; r < RPL; ++r) {
      const int j = i + lane + 32 * r;
      if (j < NV) M[j][i] = j == i ? d : t[r] * d;
    }
    __syncwarp();
  }
  CLK(2);
  // L^-1 row by row, lanes over its columns: L^-1[j][i] at M[i][j + 1]
#pragma unroll 1
  for (int j = 0; j < NV; ++j) {
    const float dj = M[j][j];
    for (int i = lane; i <= j; i += 32) {
      float val = dj;
      if (i < j) {
        float t = M[j][i] * M[i][i + 1];
#pragma unroll 4
        for (int k = i + 1; k < j; ++k) t += M[j][k] * M[i][k + 1];
        val = -t * dj;
      }
      M[i][j + 1] = val;
    }
    __syncwarp();
  }
  CLK(3);
  // G = M^-1 = L^-T L^-1, lanes over (i <= j) pairs
  for (int t = lane; t < NPAIR; t += 32) {
    const int i = pairs[t] >> 16, j = pairs[t] & 0xffff;
    float v = M[i][j + 1] * M[j][j + 1];
#pragma unroll 4
    for (int k = j + 1; k < NV; ++k) v += M[i][k + 1] * M[j][k + 1];
    w.G[i][j] = w.G[j][i] = v;
  }
  __syncwarp();

  CLK(4);
  // ---------------- 5. RNEA bias + free velocity ----------------
  // body velocities of u = [v0, w0, qd] into w.s.v.vb; each joint's velocity-
  // product term crm(v_b, phi_j qd_j) into c; then each body's
  // acceleration a0 + the terms of the joints that move it (a0 = -g)
  {
    float (*v6)[6] = w.s.v.vb, (*c6)[6] = w.s.r.c, (*a6)[6] = w.s.r.a;
    for (int i = lane; i < NV; i += 32)   // u, in w.un until the sweeps
      w.un[i] = i < 6 ? w.st[7 + i] : qd[i - 6];
    __syncwarp();
    body_velocities(w, m, w.un, lane);
    for (int t = lane; t < 6 * ND; t += 32) {
      const int j = t / 6, k = t % 6, b = j + 1;
      const float qdj = qd[j];
      float mw[3], mv[3], x[3], y[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        mw[i] = w.phw[j][i] * qdj;
        mv[i] = w.phv[j][i] * qdj;
      }
      if (k < 3) {
        cross3(v6[b], mw, x);
        c6[j][k] = x[k];
      } else {
        cross3(v6[b] + 3, mw, x);
        cross3(v6[b], mv, y);
        c6[j][k] = x[k - 3] + y[k - 3];
      }
    }
    __syncwarp();
    for (int t = lane; t < 6 * NB; t += 32) {
      const int b = t / 6, k = t % 6;
      const float* anc = m + OFF_ANC + b * ND;
      float a = k < 3 ? 0.0f : -cfg[CFG_GX + k - 3];
#pragma unroll
      for (int j = 0; j < ND; ++j) a = fmaf(anc[j], c6[j][k], a);
      a6[b][k] = a;
    }
    __syncwarp();
    // body forces, written over the accelerations, lanes over bodies
    for (int b = lane; b < NB; b += 32) {
      float Iat[3], Iab[3], Ivt[3], Ivb[3], c1[3], c2[3], c3[3];
      inertia_apply(w.sb[b], w.hb[b], w.Ab[b], a6[b], a6[b] + 3, Iat, Iab);
      inertia_apply(w.sb[b], w.hb[b], w.Ab[b], v6[b], v6[b] + 3, Ivt, Ivb);
      cross3(v6[b], Ivt, c1);
      cross3(v6[b] + 3, Ivb, c2);
      cross3(v6[b], Ivb, c3);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        a6[b][k] = Iat[k] + (c1[k] + c2[k]);
        a6[b][3 + k] = Iab[k] + c3[k];
      }
    }
    __syncwarp();
    subtree_sums(w, m, a6, lane);
    gen_force(w, lane);
    for (int i = lane; i < NV; i += 32)   // the right-hand side over sv
      w.sv[i] = (i < 6 ? w.ext[i] : w.tau[i - 6]) - w.sv[i];
    __syncwarp();
    for (int i = lane; i < NV; i += 32) {
      const float u = i < 3 ? w.st[7 + i] : (i < 6 ? w.st[10 + i - 3] : qd[i - 6]);
      w.uf[i] = u + dt * g_row(w, i, w.sv);
    }
    __syncwarp();
  }

  CLK(5);
  // ---------------- 6. per-body Lambda_b = J_b G J_b^T, down the tree ------
  // spatial rows [w; v]; J_b's base block maps u row swap6(r) to row r.
  // J_b = J_p + phi_j e_(6+j)^T for body b = j + 1 with parent p, so
  // Lambda_b = Lambda_p + x phi_j^T + phi_j x^T + G[6+j][6+j] phi_j phi_j^T
  // with x = J_p G e_(6+j): first every x, lanes over (joint, row)
  float (*Lam)[36] = w.s.l.Lam;
  for (int t = lane; t < 6 * ND; t += 32) {
    const int j = t / 6, r = t % 6;
    const float* anc = m + OFF_ANC + ti(m, OFF_PARENT + j + 1) * ND;
    float x = w.G[swap6(r)][6 + j];
#pragma unroll
    for (int jj = 0; jj < ND; ++jj)
      x = fmaf(anc[jj] * (r < 3 ? w.phw[jj][r] : w.phv[jj][r - 3]), w.G[6 + jj][6 + j], x);
    w.s.l.x[j][r] = x;
  }
  for (int t = lane; t < 36; t += 32) Lam[0][t] = w.G[swap6(t / 6)][swap6(t % 6)];
  __syncwarp();
#pragma unroll 1
  for (int L = 1; L < NB; ++L) {   // lanes over (body of the level, entry)
    const int a = ti(m, OFF_LSTART + L);
    if (a >= NB) break;
    const int n = 36 * (ti(m, OFF_LSTART + L + 1) - a);
    for (int t = lane; t < n; t += 32) {
      const int b = ti(m, OFF_ORDER + a + t / 36), e = t % 36, r = e / 6, c = e % 6;
      const int j = b - 1, p = ti(m, OFF_PARENT + b);
      const float pr_ = r < 3 ? w.phw[j][r] : w.phv[j][r - 3];
      const float pc = c < 3 ? w.phw[j][c] : w.phv[j][c - 3];
      const float* x = w.s.l.x[j];
      Lam[b][e] = Lam[p][e] + (x[r] * pc + pr_ * x[c]) + w.G[6 + j][6 + j] * pr_ * pc;
    }
    __syncwarp();
  }
  CLK(6);
  // ---------------- 7. per-point Delassus blocks and targets, lanes over points
  float pr[PPL][3], Di[PPL][9], pmu[PPL], vtz[PPL], pa[PPL], lam[PPL][3];
#pragma unroll
  for (int s = 0; s < PPL; ++s) {
    const int p = lane + 32 * s;
    pa[s] = pmu[s] = vtz[s] = 0.0f;
    if (p < NPT) {
      float wp[3];
      point_world(w, m, p, wp);
#pragma unroll
      for (int k = 0; k < 3; ++k) pr[s][k] = wp[k] - p0[k];
      const float depth = __fsub_rn(__fadd_rn(ph[s], m[OFF_PRAD + p]), wp[2]);
      if (ptxy != nullptr) {
        ptxy[(size_t)(2 * p) * B + e] = wp[0];
        ptxy[(size_t)(2 * p + 1) * B + e] = wp[1];
      }
      pa[s] = depth > -cfg[CFG_MARGIN] ? 1.0f : 0.0f;
      w.pact[p] = pa[s];
      vtz[s] = fminf(cfg[CFG_BAUMGARTE] * fmaxf(depth - cfg[CFG_SLOP], 0.0f) / dt,
                     cfg[CFG_MAX_PUSHOUT]);   // the push-out speed, for now
    }
  }
  __syncwarp();
  for (int b = lane; b < NB; b += 32) {   // active points per body, in order
    const int z = ti(m, OFF_BPSTART + b + 1);
    float c = 0.0f;
#pragma unroll 1
    for (int k = ti(m, OFF_BPSTART + b); k < z; ++k) c += w.pact[ti(m, OFF_BPLIST + k)];
    w.cnt[b] = c;
  }
  body_velocities(w, m, w.uf, lane);   // (synchronises after cnt too)
#pragma unroll
  for (int s = 0; s < PPL; ++s) {
    const int p = lane + 32 * s;
    if (p < NPT) {
      const int b = ti(m, OFF_PBODY + p);
      const float* r = pr[s];
      const float* Lb = Lam[b];
      float Lww[3][3], Lwv[3][3], Lvw[3][3], Lvv[3][3], t0[3][3], t1[3][3], t2[3][3], t3[3][3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          Lww[i][j] = Lb[6 * i + j];
          Lwv[i][j] = Lb[6 * i + 3 + j];
          Lvw[i][j] = Lb[6 * (3 + i) + j];
          Lvv[i][j] = Lb[6 * (3 + i) + 3 + j];
        }
      // skew(r) @ A (rows) and A @ skew(r) (columns)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        t0[0][j] = r[1] * Lww[2][j] - r[2] * Lww[1][j];
        t0[1][j] = r[2] * Lww[0][j] - r[0] * Lww[2][j];
        t0[2][j] = r[0] * Lww[1][j] - r[1] * Lww[0][j];
        t2[0][j] = r[1] * Lwv[2][j] - r[2] * Lwv[1][j];
        t2[1][j] = r[2] * Lwv[0][j] - r[0] * Lwv[2][j];
        t2[2][j] = r[0] * Lwv[1][j] - r[1] * Lwv[0][j];
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        t1[i][0] = t0[i][1] * r[2] - t0[i][2] * r[1];
        t1[i][1] = t0[i][2] * r[0] - t0[i][0] * r[2];
        t1[i][2] = t0[i][0] * r[1] - t0[i][1] * r[0];
        t3[i][0] = Lvw[i][1] * r[2] - Lvw[i][2] * r[1];
        t3[i][1] = Lvw[i][2] * r[0] - Lvw[i][0] * r[2];
        t3[i][2] = Lvw[i][0] * r[1] - Lvw[i][1] * r[0];
      }
      const float split = fmaxf(w.cnt[b], 1.0f);
      float D[9];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          D[3 * i + j] = (Lvv[i][j] - t1[i][j] - t2[i][j] + t3[i][j]) * split
                         + (i == j ? 1e-8f : 0.0f);
      const float a = D[0], b_ = D[1], c = D[2], d_ = D[3], e_ = D[4], f_ = D[5], g = D[6],
                  h = D[7], i_ = D[8];
      const float co_a = e_ * i_ - f_ * h, co_b = c * h - b_ * i_, co_c = b_ * f_ - c * e_;
      const float idet = 1.0f / (a * co_a + d_ * co_b + g * co_c);
      float* Dv = Di[s];
      Dv[0] = co_a * idet; Dv[1] = co_b * idet; Dv[2] = co_c * idet;
      Dv[3] = (f_ * g - d_ * i_) * idet; Dv[4] = (a * i_ - c * g) * idet;
      Dv[5] = (c * d_ - a * f_) * idet;
      Dv[6] = (d_ * h - e_ * g) * idet; Dv[7] = (b_ * g - a * h) * idet;
      Dv[8] = (a * e_ - b_ * d_) * idet;
      const int sh = ti(m, OFF_PSHAPE + p);
      pmu[s] = 0.5f * (w.dyn[10 * NB + sh] + cfg[CFG_TFRIC]);
      const float rest = 0.5f * (w.dyn[10 * NB + NS + sh] + cfg[CFG_TREST]);
      float v[3];
      point_velocity(w, b, r, v);
      const float vn_pre = dot_n(v, pn[s]);   // the approach speed along n
      const float bounce = vn_pre < -cfg[CFG_BOUNCE] ? -rest * vn_pre : 0.0f;
      vtz[s] = fmaxf(vtz[s], bounce);         // the target's length along n
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) lam[s][k] = 0.0f;
  }
  __syncwarp();   // every lane is done with Lambda before w.s.pw overwrites it

  CLK(7);
  // ---------------- 8. Jacobi sweeps, friction cone about n ---------------
  // Sweep 0 starts from lam = 0, so its velocities are those of uf,
  // already in w.s.v.vb.
  const int iters = (int)cfg[CFG_ITERS];
  const float relax = cfg[CFG_RELAX];
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    if (it > 0) {
      wrench_du(w, m, pr, lam, lane);
      CLK(8);
      body_velocities(w, m, w.un, lane);
      CLK(9);
    }
#pragma unroll
    for (int s = 0; s < PPL; ++s) {
      const int p = lane + 32 * s;
      if (p < NPT) {
        const int b = ti(m, OFF_PBODY + p);
        const float* n = pn[s];
        float v[3], dv[3], ln[3], ltv[3];
        point_velocity(w, b, pr[s], v);
        // the target vtz n minus the point velocity
#pragma unroll
        for (int k = 0; k < 3; ++k) dv[k] = __fsub_rn(__fmul_rn(n[k], vtz[s]), v[k]);
#pragma unroll
        for (int k = 0; k < 3; ++k)
          ln[k] = __fmaf_rn(relax, dot_n(&Di[s][3 * k], dv), lam[s][k]);
        // normal part clamped at 0, tangential part scaled into the cone
        const float ldn = dot_n(ln, n);
        const float lz = fmaxf(ldn, 0.0f);
#pragma unroll
        for (int k = 0; k < 3; ++k) ltv[k] = __fsub_rn(ln[k], __fmul_rn(ldn, n[k]));
        const float lt = __fsqrt_rn(__fadd_rn(dot_n(ltv, ltv), 1e-18f));
        const float scale = fminf(1.0f, __fdiv_rn(__fmul_rn(pmu[s], lz), lt));
#pragma unroll
        for (int k = 0; k < 3; ++k)
          lam[s][k] = __fmul_rn(__fmaf_rn(ltv[k], scale, __fmul_rn(n[k], lz)), pa[s]);
      }
    }
    CLK(10);
  }
  wrench_du(w, m, pr, lam, lane);
  CLK(8);

  // ---------------- 9. integrate ----------------
  if (lane == 0) {
    float v0[3], w0[3], wxv[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      v0[k] = w.st[7 + k];
      w0[k] = w.st[10 + k];
    }
    cross3(w0, v0, wxv);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float vnew = w.un[k] + dt * wxv[k];
      w.st[k] = p0[k] + dt * vnew;
      w.st[7 + k] = vnew;
      w.st[10 + k] = w.un[3 + k];
    }
    const float wx = w.un[3], wy = w.un[4], wz = w.un[5];
    const float ang = sqrtf(wx * wx + wy * wy + wz * wz + 1e-18f);
    const float half = 0.5f * dt * ang;
    const float sc_ = sinf(half) / ang, dw = cosf(half);
    const float dx = wx * sc_, dy = wy * sc_, dz = wz * sc_;
    const float qw = w.st[3], qx = w.st[4], qy = w.st[5], qz = w.st[6];
    const float nqw = dw * qw - dx * qx - dy * qy - dz * qz;
    const float nqx = dw * qx + dx * qw + dy * qz - dz * qy;
    const float nqy = dw * qy - dx * qz + dy * qw + dz * qx;
    const float nqz = dw * qz + dx * qy - dy * qx + dz * qw;
    const float norm = rsqrtf(nqw * nqw + nqx * nqx + nqy * nqy + nqz * nqz);
    w.st[3] = nqw * norm;
    w.st[4] = nqx * norm;
    w.st[5] = nqy * norm;
    w.st[6] = nqz * norm;
  }
  for (int j = lane; j < ND; j += 32) {
    float qdn = w.un[6 + j];
    const float qn = w.st[13 + j] + dt * qdn;
    const float lo = m[OFF_LO + j], hi = m[OFF_HI + j];
    if (qn < lo) qdn = fmaxf(qdn, 0.0f);
    if (qn > hi) qdn = fminf(qdn, 0.0f);
    w.st[13 + j] = fminf(fmaxf(qn, lo), hi);
    w.st[13 + ND + j] = qdn;
  }
  __syncwarp();
  CLK(11);
}

// ---------------------------------------------------------------------------
// Kernels.  Shared memory: the model table (index blocks as ints), the
// (i <= j) pairs of an NV x NV lower triangle, then EPB env working sets
// (SMEM_BYTES, above).

__device__ __forceinline__ EnvWS* setup_block(const float* __restrict__ mdl, float*& m,
                                              int*& pairs) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  pairs = reinterpret_cast<int*>(sm + MDL_LEN);
  for (int i = threadIdx.x; i < MDL_LEN; i += blockDim.x) {
    const float v = mdl[i];
    const bool index = i < OFF_PARENT + NB || (i >= OFF_PBODY && i < OFF_PPOS)
                       || (i >= OFF_FEET && i < OFF_CFG);
    sm[i] = index ? __int_as_float((int)v) : v;
  }
  for (int t = threadIdx.x; t < NPAIR; t += blockDim.x) {
    int i = 0, r = t;
    while (r >= NV - i) {
      r -= NV - i;
      ++i;
    }
    pairs[t] = (i << 16) | (i + r);
  }
  __syncthreads();
  m = sm;
  return reinterpret_cast<EnvWS*>(pairs + NPAIR);
}

// the element strides of K5's terrain inputs: height p of env e at
// h_in[p hc + e he], normal component c = 3 p + k at n_in[c nc + e ne]
struct TerrainIn {
  int hc, he, nc, ne;
};

// each lane's points' terrain: read once (K5), or the plane's constants (K1)
__device__ __forceinline__ void load_terrain(const float* __restrict__ h_in,
                                             const float* __restrict__ n_in,
                                             const TerrainIn& st, int lane, int e,
                                             float (&ph)[PPL], float (&pn)[PPL][3]) {
#pragma unroll
  for (int s = 0; s < PPL; ++s) {
    const int p = lane + 32 * s;
    ph[s] = 0.0f;
    pn[s][0] = 0.0f;
    pn[s][1] = 0.0f;
    pn[s][2] = 1.0f;
#if !PLANE
    if (p < NPT) {
      ph[s] = h_in[(size_t)p * st.hc + (size_t)e * st.he];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        pn[s][k] = n_in[(size_t)(3 * p + k) * st.nc + (size_t)e * st.ne];
    }
#endif
  }
}

__device__ __forceinline__ void load_state(EnvWS& w, const float* __restrict__ s_in,
                                           const float* __restrict__ dyn, int lane, int e,
                                           int B) {
  for (int c = lane; c < NSTATE; c += 32) w.st[c] = s_in[(size_t)c * B + e];
  for (int c = lane; c < NDYN; c += 32) w.dyn[c] = dyn[(size_t)c * B + e];
}

// the state, the contact force per body and the feet poses out
__device__ __forceinline__ void store_outputs(const EnvWS& w, const float* m, int lane, int e,
                                              int B, float* __restrict__ s_out,
                                              float* __restrict__ f_out,
                                              float* __restrict__ feet_out) {
  const float dt = m[OFF_CFG + CFG_DT];
  for (int c = lane; c < NSTATE; c += 32) s_out[(size_t)c * B + e] = w.st[c];
  for (int t = lane; t < 3 * NB; t += 32) f_out[(size_t)t * B + e] = w.s.sw.wb[t / 3][3 + t % 3] / dt;
  for (int t = lane; t < 12 * NF; t += 32) {
    const int b = ti(m, OFF_FEET + t / 12), k = t % 12;
    feet_out[(size_t)t * B + e] = k < 3 ? w.P[b][k] : w.R[b][k - 3];
  }
}

// The control step's epilogue, env-major outputs (a warp's stores are
// contiguous): each lane's queries q = lane + 32 s; foot edge point k
// (query NPT + 1 + k) as p + R e in t1.py's order, ((p_i + R_i0 e_0) +
// R_i1 e_1) + R_i2 e_2, to edge_out [B, 3, NEDGE]; K5 with a field hf also
// each query's height and normal to h_out [B, NQ] and n_out [B, NQ, 3], on
// the patch of the env's root (its origin found once a lane), the contact
// points' xy from the last substep's FK by point_world, as the substep
// computed them (the ptxy it wrote), the root's from the state.  The slots
// are unrolled, so one slot's loads wait beside the others'.
__device__ __forceinline__ void control_epilogue(const EnvWS& w, const float* m, int lane, int e,
                                                 int B, const float* __restrict__ edge_pos,
                                                 float* __restrict__ edge_out,
                                                 const float* __restrict__ hf, int R, int C,
                                                 float bp, float hs, float* __restrict__ h_out,
                                                 float* __restrict__ n_out) {
#if !PLANE
  int ox = 0, oy = 0;
  if (hf != nullptr) terrain_patch(R, C, bp, hs, w.st[0], w.st[1], &ox, &oy);
#endif
#pragma unroll
  for (int s = 0; s < QPL; ++s) {
    const int q = lane + 32 * s;
    if (q >= NQ) break;
    float x = 0.0f, y = 0.0f;
#if NE > 0
    if (q > NPT) {
      const int k = q - NPT - 1, b = ti(m, OFF_FEET + k / NE);
      const float* ep = edge_pos + 3 * (k % NE);
      float c[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        c[i] = __fadd_rn(__fadd_rn(__fadd_rn(w.P[b][i], __fmul_rn(w.R[b][3 * i], ep[0])),
                                   __fmul_rn(w.R[b][3 * i + 1], ep[1])),
                         __fmul_rn(w.R[b][3 * i + 2], ep[2]));
        edge_out[((size_t)e * 3 + i) * NEDGE + k] = c[i];
      }
      x = c[0];
      y = c[1];
    }
#endif
#if !PLANE
    if (hf != nullptr) {
      if (q < NPT) {
        float wp[3];
        point_world(w, m, q, wp);
        x = wp[0];
        y = wp[1];
      } else if (q == NPT) {
        x = w.st[0];
        y = w.st[1];
      }
      float h, n[3];
      terrain_sample_at(hf, R, C, bp, hs, ox, oy, x, y, &h, n);
      h_out[(size_t)e * NQ + q] = h;
#pragma unroll
      for (int k = 0; k < 3; ++k) n_out[((size_t)e * NQ + q) * 3 + k] = n[k];
    }
#endif
  }
}

// One substep; every tensor component-major [comp, B].
__global__ void __launch_bounds__(32 * EPB, MINB)
substep_kernel(const float* __restrict__ s_in, const float* __restrict__ dyn,
               const float* __restrict__ tau_in, const float* __restrict__ ext_in,
               const float* __restrict__ h_in, const float* __restrict__ n_in,
               float* __restrict__ ptxy_out, const float* __restrict__ mdl,
               float* __restrict__ s_out, float* __restrict__ f_out,
               float* __restrict__ feet_out, int B) {
  float* m;
  int* pairs;
  EnvWS* ws = setup_block(mdl, m, pairs);
  const int lane = threadIdx.x & 31, e = blockIdx.x * EPB + (threadIdx.x >> 5);
  if (e >= B) return;   // ragged edge: masked, never padded
  EnvWS& w = ws[threadIdx.x >> 5];
  load_state(w, s_in, dyn, lane, e, B);
  for (int j = lane; j < ND; j += 32) w.tau[j] = tau_in[(size_t)j * B + e];
  if (lane < 6) w.ext[lane] = ext_in[(size_t)lane * B + e];
  float ph[PPL], pn[PPL][3];
  load_terrain(h_in, n_in, TerrainIn{B, 1, B, 1}, lane, e, ph, pn);
  __syncwarp();
  substep(w, m, pairs, lane, ph, pn, PLANE ? nullptr : ptxy_out, e, B);
  store_outputs(w, m, lane, e, B, s_out, f_out, feet_out);
}

// One control step: `decimation` substeps, each after the delay latch
// (last = targets from substep delay on), PD, Coulomb joint friction and the
// torque clip; the push on substep 0 only; then the epilogue.  The state,
// dyn and the contact points' terrain stay on chip; the per-dof inputs and
// outputs are batch-leading [B, ND] (lanes read an env's row), delay [B]
// int64, lim [ND], ext [B, 6], edge_pos [NE, 3]; the rest component-major
// [comp, B], the terrain inputs at tin's strides, the epilogue's outputs
// env-major.
__global__ void __launch_bounds__(32 * EPB, MINB)
control_kernel(const float* __restrict__ s_in, const float* __restrict__ dyn,
               const float* __restrict__ targets, const float* __restrict__ last_in,
               const long long* __restrict__ delay, const float* __restrict__ kp_in,
               const float* __restrict__ kd_in, const float* __restrict__ fric_in,
               const float* __restrict__ lim_in, const float* __restrict__ ext_in,
               const float* __restrict__ h_in, const float* __restrict__ n_in,
               TerrainIn tin, float* __restrict__ ptxy_out, const float* __restrict__ mdl,
               float* __restrict__ s_out, float* __restrict__ last_out,
               float* __restrict__ tsum_out, float* __restrict__ f_out,
               float* __restrict__ feet_out, int B, int decimation,
               const float* __restrict__ edge_pos, float* __restrict__ edge_out,
               const float* __restrict__ hf, int R, int C, float bp, float hs,
               float* __restrict__ h_out, float* __restrict__ n_out) {
  float* m;
  int* pairs;
  EnvWS* ws = setup_block(mdl, m, pairs);
  const int lane = threadIdx.x & 31, e = blockIdx.x * EPB + (threadIdx.x >> 5);
  if (e >= B) return;
  EnvWS& w = ws[threadIdx.x >> 5];
  load_state(w, s_in, dyn, lane, e, B);
  if (lane < 6) w.ext[lane] = ext_in[(size_t)e * 6 + lane];
  float ph[PPL], pn[PPL][3];
  load_terrain(h_in, n_in, tin, lane, e, ph, pn);
  // each lane's dofs carry the latched target and the torque sum; the
  // gains, friction, limit and target are read where they are used (L1)
  float last[DPL], tsum[DPL];
#pragma unroll
  for (int r = 0; r < DPL; ++r) {
    const int j = lane + 32 * r;
    last[r] = j < ND ? last_in[(size_t)e * ND + j] : 0.0f;
    tsum[r] = 0.0f;
  }
  const long long dl = delay[e];
  __syncwarp();
#pragma unroll 1
  for (int i = 0; i < decimation; ++i) {
    if (i == 1 && lane < 6) w.ext[lane] = 0.0f;   // the push acts on substep 0 only
#pragma unroll
    for (int r = 0; r < DPL; ++r) {
      const int j = lane + 32 * r;
      if (j < ND) {
        const size_t o = (size_t)e * ND + j;
        if (dl == i) last[r] = targets[o];
        // each operation rounded on its own, as the plain loop's tensor ops
        const float pd = __fsub_rn(__fmul_rn(kp_in[o], __fsub_rn(last[r], w.st[13 + j])),
                                   __fmul_rn(kd_in[o], w.st[13 + ND + j]));
        const float sgn = pd > 0.0f ? 1.0f : (pd < 0.0f ? -1.0f : 0.0f);
        const float fric = __fmul_rn(fminf(fabsf(pd), fric_in[o]), sgn);
        const float lim = lim_in[j];
        const float tau = fminf(fmaxf(__fsub_rn(pd, fric), -lim), lim);
        w.tau[j] = tau;
        tsum[r] = __fadd_rn(tsum[r], tau);
      }
    }
    __syncwarp();
    substep(w, m, pairs, lane, ph, pn, (!PLANE && i == decimation - 1) ? ptxy_out : nullptr,
            e, B);
  }
  store_outputs(w, m, lane, e, B, s_out, f_out, feet_out);
#pragma unroll
  for (int r = 0; r < DPL; ++r) {
    const int j = lane + 32 * r;
    if (j < ND) {
      last_out[(size_t)e * ND + j] = last[r];
      tsum_out[(size_t)e * ND + j] = tsum[r];
    }
  }
#if EPILOGUE
  control_epilogue(w, m, lane, e, B, edge_pos, edge_out, hf, R, C, bp, hs, h_out, n_out);
#endif
}

// ---------------------------------------------------------------------------
// Plain C entry points for ctypes.  Each launches on `stream` and returns
// cudaGetLastError() (0 on success); none synchronizes.
static int allow_smem(const void* fn) {
  if (SMEM_BYTES <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)SMEM_BYTES);
}

static int launch_substep(const float* s_in, const float* dyn, const float* tau,
                          const float* ext, const float* h_in, const float* n_in,
                          const float* mdl, float* s_out, float* f_out, float* feet_out,
                          float* ptxy_out, int B, void* stream) {
  if (B <= 0) return 0;
  static int ready = allow_smem((const void*)substep_kernel);
  if (ready != 0) return ready;
  const int grid = (B + EPB - 1) / EPB;
  substep_kernel<<<grid, 32 * EPB, SMEM_BYTES, (cudaStream_t)stream>>>(
      s_in, dyn, tau, ext, h_in, n_in, ptxy_out, mdl, s_out, f_out, feet_out, B);
  return (int)cudaGetLastError();
}

// the epilogue's arguments: the edge offsets and points, and K5's field
// (null: no sampling) with its size and scale and the queries' outputs
struct Epilogue {
  const float* edge_pos;
  float* edge_out;
  const float* hf;
  int R, C;
  float bp, hs;
  float *h_out, *n_out;
};

static int launch_control(const float* s_in, const float* dyn, const float* targets,
                          const float* last_in, const long long* delay, const float* kp,
                          const float* kd, const float* fric, const float* lim,
                          const float* ext, const float* h_in, const float* n_in,
                          const TerrainIn& tin, const float* mdl, float* s_out, float* last_out,
                          float* tsum_out, float* f_out, float* feet_out, float* ptxy_out,
                          int B, int decimation, const Epilogue& ep, void* stream) {
  if (B <= 0) return 0;
  static int ready = allow_smem((const void*)control_kernel);
  if (ready != 0) return ready;
  const int grid = (B + EPB - 1) / EPB;
  control_kernel<<<grid, 32 * EPB, SMEM_BYTES, (cudaStream_t)stream>>>(
      s_in, dyn, targets, last_in, delay, kp, kd, fric, lim, ext, h_in, n_in, tin, ptxy_out, mdl,
      s_out, last_out, tsum_out, f_out, feet_out, B, decimation, ep.edge_pos, ep.edge_out, ep.hf,
      ep.R, ep.C, ep.bp, ep.hs, ep.h_out, ep.n_out);
  return (int)cudaGetLastError();
}

// out[0] shared memory per block (bytes), out[1] envs per block, out[2] and
// out[3] resident blocks per SM of the substep and the control-step kernel,
// out[4] the resident blocks per SM asked of ptxas (MINB)
extern "C" int bg_substep_info(int* out) {
  int err = allow_smem((const void*)substep_kernel);
  if (err == 0) err = allow_smem((const void*)control_kernel);
  out[0] = (int)SMEM_BYTES;
  out[1] = EPB;
  out[4] = MINB;
  if (err == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], substep_kernel, 32 * EPB,
                                                             SMEM_BYTES);
  if (err == 0)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], control_kernel, 32 * EPB,
                                                             SMEM_BYTES);
  return err;
}

#if PHASE_CLOCKS
// the phase clocks summed over warps since the last call, then cleared
extern "C" int bg_substep_clocks(unsigned long long* out) {
  int err = (int)cudaMemcpyFromSymbol(out, bg_clk, sizeof(bg_clk));
  static const unsigned long long zeros[NCLK] = {};
  if (err == 0) err = (int)cudaMemcpyToSymbol(bg_clk, zeros, sizeof(bg_clk));
  return err;
}
#endif

#if PLANE
extern "C" int bg_substep(const float* s_in, const float* dyn, const float* tau,
                          const float* ext, const float* mdl, float* s_out, float* f_out,
                          float* feet_out, int B, void* stream) {
  return launch_substep(s_in, dyn, tau, ext, nullptr, nullptr, mdl, s_out, f_out, feet_out,
                        nullptr, B, stream);
}

// edge_pos [NE, 3], edge_out [3 NF NE, B] (null when NE = 0)
extern "C" int bg_control(const float* s_in, const float* dyn, const float* targets,
                          const float* last_in, const long long* delay, const float* kp,
                          const float* kd, const float* fric, const float* lim,
                          const float* ext, const float* mdl, const float* edge_pos,
                          float* s_out, float* last_out, float* tsum_out, float* f_out,
                          float* feet_out, float* edge_out, int B, int decimation,
                          void* stream) {
  const Epilogue ep = {edge_pos, edge_out, nullptr, 0, 0, 0.0f, 0.0f, nullptr, nullptr};
  return launch_control(s_in, dyn, targets, last_in, delay, kp, kd, fric, lim, ext, nullptr,
                        nullptr, TerrainIn{0, 0, 0, 0}, mdl, s_out, last_out, tsum_out, f_out,
                        feet_out, nullptr, B, decimation, ep, stream);
}
#else
extern "C" int bg_substep_terrain(const float* s_in, const float* dyn, const float* tau,
                                  const float* ext, const float* h_in, const float* n_in,
                                  const float* mdl, float* s_out, float* f_out,
                                  float* feet_out, float* ptxy_out, int B, void* stream) {
  return launch_substep(s_in, dyn, tau, ext, h_in, n_in, mdl, s_out, f_out, feet_out, ptxy_out,
                        B, stream);
}

// h_in, n_in: the points' heights and normals at the element strides hc,
// he, nc, ne (TerrainIn); edge_pos, edge_out as for bg_control; hf [R, C]
// the field under the queries, or null (then h_out and n_out are not
// written): its border pixels bp and horizontal scale hs; h_out [B, NQ],
// n_out [B, NQ, 3]
extern "C" int bg_control_terrain(const float* s_in, const float* dyn, const float* targets,
                                  const float* last_in, const long long* delay,
                                  const float* kp, const float* kd, const float* fric,
                                  const float* lim, const float* ext, const float* h_in,
                                  const float* n_in, const float* mdl, const float* edge_pos,
                                  const float* hf, float* s_out, float* last_out,
                                  float* tsum_out, float* f_out, float* feet_out,
                                  float* ptxy_out, float* edge_out, float* h_out, float* n_out,
                                  int hc, int he, int nc, int ne, int R, int C, float bp,
                                  float hs, int B, int decimation, void* stream) {
  const Epilogue ep = {edge_pos, edge_out, hf, R, C, bp, hs, h_out, n_out};
  return launch_control(s_in, dyn, targets, last_in, delay, kp, kd, fric, lim, ext, h_in, n_in,
                        TerrainIn{hc, he, nc, ne}, mdl, s_out, last_out, tsum_out, f_out,
                        feet_out, ptxy_out, B, decimation, ep, stream);
}
#endif
