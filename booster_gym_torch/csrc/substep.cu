// K1 and K5: one physics substep per env, for Hopper (sm_90a).  One source,
// two builds: -DPLANE=1 (the default) is K1, the plane-terrain substep;
// -DPLANE=0 is K5, the general-terrain substep.
//
// Replaces the TPU kernel booster_gym_tpu/physics/pallas_engine.py ::
// make_substep_pallas(model, cfg, feet_indices, plane=...), inner `kernel`
// (lines 267-720, launched at line 811): K1 its plane=True specialization,
// K5 its plane=False branches (lines 507-512, 596-606, 636-664, 715-720).
// Same steps in the same order:
//   1. FK down the static tree;
//   2. spatial inertias about the base origin;
//   3. CRBA mass matrix plus the diagonal regularizer;
//   4. Cholesky inverse with a reciprocal square root per pivot;
//   5. RNEA bias and the free (contact-less) velocity;
//   6. per-body Delassus operators Lambda_b = J_b M^-1 J_b^T;
//   7. per-point 3x3 Delassus blocks, split by the body's active points,
//      closed-form inverses, pushout and restitution targets;
//   8. Jacobi sweeps with the friction cone about +z;
//   9. quaternion-exponential integration and joint-limit projection;
//  10. feet poses from the start-of-substep FK.
// K5 takes a terrain height h [NPT, B] and a unit normal n [3 NPT, B] per
// contact point, constant over the substep: the depth is h + radius - z,
// the approach speed and the push-out target lie along n, the friction cone
// opens about n, and the points' world xy from step 1's FK go out as
// ptxy [2 NPT, B] for the caller's next terrain query.  h and n are read
// from global memory where they are used (L1 holds them between the
// sweeps) and ptxy is written as each point is placed, so K5 adds no
// per-point local array to K1's.  On plane inputs (h = 0, n = +z) every
// K5 formula reduces to K1's by exact multiplications by 0 and 1, and
// chip_smoke.py holds the two builds to a difference of 0 there.
// All arithmetic is f32.  The plain PyTorch version of the same function is
// booster_gym_torch/physics/engine.py::make_substep (its `step` for K1,
// its `step.terrain_form` for K5).
//
// Design (first version: simple and right).  One thread per env; the
// TPU's [comp, G, 8, 128] tiles are not carried over.  Every input and
// output is component-major [comp, B] f32, so neighbouring threads read
// neighbouring addresses.  The robot enters as one small table of f32
// (parent, joint frames and axes, ancestor mask, dof limits, contact
// points, feet, solver constants; layout in model_tables() of
// physics/substep_kernel.py) that the kernel walks in tree order; the sizes
// NB, ND, NPT, NS, NF are compile-time -D constants, and the library's file
// name carries them.  The ragged edge of the batch is masked: no padding,
// and the real envs' results do not depend on B.
//
// What bounds it on an H100 (SXM, 3.35 TB/s, 67 TFLOP/s f32 outside the
// tensor cores).  Counted for the T1 widths (nb 13, nd 12, npt 56, ns 7,
// nf 2) per env and substep: it reads 37 state + 144 dyn + 12 tau + 6 ext
// = 199 floats and writes 37 state + 39 forces + 24 feet = 100 floats,
// 1196 bytes; at 4096 envs 4.9 MB, 1.46 us at 3.35 TB/s.  Its arithmetic
// is ~5.8e4 f32 operations per env (chip_smoke.py counts them from the
// loop trip counts of this file), 2.4e8 at 4096 envs, 3.5 us at
// 67 TFLOP/s.  So the operations bound it, at 3.5 us.  K5 reads 4 NPT and
// writes 2 NPT more floats per env (2,540 bytes, 10.4 MB at 4096 envs,
// 3.1 us) and does ~6.4e4 operations per env (2.6e8, 3.9 us): the
// operations bound it too.  Known weaknesses,
// left for later work: 4096 threads fill far less than one wave of 132
// SMs; the 18x18 mass matrix, its inverse and the per-point blocks live in
// local memory (ptxas: 255 registers and an 11.6 KB stack frame per thread
// at the T1 widths); and the decimation loop around it costs 10 launches
// per control step.

#include <cuda_runtime.h>

#if !defined(NB) || !defined(ND) || !defined(NPT) || !defined(NS) || !defined(NF)
#error "compile with -DNB=.. -DND=.. -DNPT=.. -DNS=.. -DNF=.."
#endif

#ifndef PLANE
#define PLANE 1
#endif

#define NV (6 + ND)
#define NSTATE (13 + 2 * ND)
#define NDYN (10 * NB + 2 * NS)
#define BLOCK 32

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
#define OFF_CFG (OFF_FEET + NF)
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
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      o[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

// o = A @ v
__device__ __forceinline__ void mv33(const float* A, const float* v, float* o) {
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
  for (int i = 0; i < 3; ++i) {
    top[i] = s6(A, i, 0) * w[0] + s6(A, i, 1) * w[1] + s6(A, i, 2) * w[2] + hxv[i];
    bot[i] = -hxw[i] + v[i] * s;
  }
}

__device__ __forceinline__ int swap6(int i) { return i < 3 ? i + 3 : i - 3; }

// out = G @ x, summed in index order
__device__ __forceinline__ void minv_vec(const float (*G)[NV], const float* x, float* out) {
#pragma unroll 1
  for (int i = 0; i < NV; ++i) {
    float acc = G[i][0] * x[0];
    for (int k = 1; k < NV; ++k) acc += G[i][k] * x[k];
    out[i] = acc;
  }
}

// body spatial velocities (bw = angular, bv = linear at the base origin)
// from a generalized velocity u = [v0, w0, qd]
__device__ __forceinline__ void body_velocities(const float* mdl, const float* u,
                                                const float (*phw)[3], const float (*phv)[3],
                                                float (*bw)[3], float (*bv)[3]) {
  for (int k = 0; k < 3; ++k) {
    bw[0][k] = u[3 + k];
    bv[0][k] = u[k];
  }
#pragma unroll 1
  for (int b = 1; b < NB; ++b) {
    const int p = (int)mdl[OFF_PARENT + b];
    const float qdj = u[6 + b - 1];
    for (int k = 0; k < 3; ++k) {
      bw[b][k] = bw[p][k] + phw[b - 1][k] * qdj;
      bv[b][k] = bv[p][k] + phv[b - 1][k] * qdj;
    }
  }
}

// per-body contact wrenches (wt torque about the base origin, wf force)
// of the point impulses, and du = M^-1 J^T w
__device__ __forceinline__ void wrench_and_du(const float* mdl, const float (*lam)[3],
                                              const float (*pr)[3], const float (*phw)[3],
                                              const float (*phv)[3], const float (*G)[NV],
                                              float (*wt)[3], float (*wf)[3], float* du) {
  float at[NB][3], af[NB][3], svec[NV];
  for (int b = 0; b < NB; ++b)
    for (int k = 0; k < 3; ++k) wt[b][k] = wf[b][k] = 0.0f;
#pragma unroll 1
  for (int p = 0; p < NPT; ++p) {
    const int b = (int)mdl[OFF_PBODY + p];
    float t[3];
    cross3(pr[p], lam[p], t);
    for (int k = 0; k < 3; ++k) {
      wt[b][k] += t[k];
      wf[b][k] += lam[p][k];
    }
  }
  for (int b = 0; b < NB; ++b)
    for (int k = 0; k < 3; ++k) {
      at[b][k] = wt[b][k];
      af[b][k] = wf[b][k];
    }
#pragma unroll 1
  for (int b = NB - 1; b > 0; --b) {
    const int p = (int)mdl[OFF_PARENT + b];
    for (int k = 0; k < 3; ++k) {
      at[p][k] += at[b][k];
      af[p][k] += af[b][k];
    }
  }
  for (int k = 0; k < 3; ++k) {
    svec[k] = af[0][k];
    svec[3 + k] = at[0][k];
  }
  for (int j = 0; j < ND; ++j) svec[6 + j] = dot3(phw[j], at[j + 1]) + dot3(phv[j], af[j + 1]);
  minv_vec(G, svec, du);
}

__global__ void __launch_bounds__(BLOCK)
substep_kernel(const float* __restrict__ s_in, const float* __restrict__ dyn,
               const float* __restrict__ tau_in, const float* __restrict__ ext_in,
#if !PLANE
               const float* __restrict__ h_in, const float* __restrict__ n_in,
               float* __restrict__ ptxy_out,
#endif
               const float* __restrict__ mdl, float* __restrict__ s_out,
               float* __restrict__ f_out, float* __restrict__ feet_out, int B) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;  // ragged edge: masked, never padded
#define IN(ptr, row) ptr[(size_t)(row) * B + e]
  const float* cfg = mdl + OFF_CFG;
  const float dt = cfg[CFG_DT];

  float p0[3], quat[4], v0[3], w0[3], q[ND], qd[ND], tau[ND], ext[6];
  for (int k = 0; k < 3; ++k) {
    p0[k] = IN(s_in, k);
    v0[k] = IN(s_in, 7 + k);
    w0[k] = IN(s_in, 10 + k);
  }
  for (int k = 0; k < 4; ++k) quat[k] = IN(s_in, 3 + k);
  for (int j = 0; j < ND; ++j) {
    q[j] = IN(s_in, 13 + j);
    qd[j] = IN(s_in, 13 + ND + j);
    tau[j] = IN(tau_in, j);
  }
  for (int k = 0; k < 6; ++k) ext[k] = IN(ext_in, k);

  // ---------------- 1. FK ----------------
  float R[NB][9], P[NB][3], phw[ND][3], phv[ND][3];
  {
    const float w = quat[0], x = quat[1], y = quat[2], z = quat[3];
    R[0][0] = 1 - 2 * (y * y + z * z); R[0][1] = 2 * (x * y - w * z); R[0][2] = 2 * (x * z + w * y);
    R[0][3] = 2 * (x * y + w * z); R[0][4] = 1 - 2 * (x * x + z * z); R[0][5] = 2 * (y * z - w * x);
    R[0][6] = 2 * (x * z - w * y); R[0][7] = 2 * (y * z + w * x); R[0][8] = 1 - 2 * (x * x + y * y);
  }
  for (int k = 0; k < 3; ++k) P[0][k] = p0[k];
#pragma unroll 1
  for (int b = 1; b < NB; ++b) {
    const int p = (int)mdl[OFF_PARENT + b];
    const float* jrot = mdl + OFF_JROT + 9 * b;
    const float* jp = mdl + OFF_JPOS + 3 * b;
    const float* ax = mdl + OFF_JAXIS + 3 * b;
    float jR[9], rod[9], t[3];
    mul33(R[p], jrot, jR);
    mv33(R[p], jp, t);
    for (int k = 0; k < 3; ++k) P[b][k] = P[p][k] + t[k];
    // Rodrigues about the constant axis: I + sin(q) K + (1 - cos(q)) K^2
    const float s = sinf(q[b - 1]), c1 = 1.0f - cosf(q[b - 1]);
    const float K[9] = {0.0f, -ax[2], ax[1], ax[2], 0.0f, -ax[0], -ax[1], ax[0], 0.0f};
    float K2[9];
    mul33(K, K, K2);
    for (int i = 0; i < 9; ++i) rod[i] = (i % 4 == 0 ? 1.0f : 0.0f) + s * K[i] + c1 * K2[i];
    mul33(jR, rod, R[b]);
    mv33(jR, ax, phw[b - 1]);
    float c[3];
    for (int k = 0; k < 3; ++k) c[k] = P[b][k] - p0[k];
    cross3(c, phw[b - 1], phv[b - 1]);
  }

  // ---------------- 2. spatial inertias at the base origin ----------------
  float sb[NB], hb[NB][3], Ab[NB][6];
#pragma unroll 1
  for (int b = 0; b < NB; ++b) {
    const float m = IN(dyn, b);
    float cl[3], cw[3], Il[6], T[9], Im[9];
    for (int k = 0; k < 3; ++k) cl[k] = IN(dyn, NB + 3 * b + k);
    for (int k = 0; k < 6; ++k) Il[k] = IN(dyn, 4 * NB + 6 * b + k);  // xx yy zz xy xz yz
    mv33(R[b], cl, cw);
    for (int k = 0; k < 3; ++k) cw[k] += P[b][k] - p0[k];
    Im[0] = Il[0]; Im[1] = Il[3]; Im[2] = Il[4];
    Im[3] = Il[3]; Im[4] = Il[1]; Im[5] = Il[5];
    Im[6] = Il[4]; Im[7] = Il[5]; Im[8] = Il[2];
    mul33(R[b], Im, T);
    float Iw[3][3];
    for (int i = 0; i < 3; ++i)
      for (int j = i; j < 3; ++j)
        Iw[i][j] = T[3 * i] * R[b][3 * j] + T[3 * i + 1] * R[b][3 * j + 1] + T[3 * i + 2] * R[b][3 * j + 2];
    const float c2 = dot3(cw, cw);
    Ab[b][0] = Iw[0][0] + m * (c2 - cw[0] * cw[0]);
    Ab[b][1] = Iw[0][1] - m * cw[0] * cw[1];
    Ab[b][2] = Iw[0][2] - m * cw[0] * cw[2];
    Ab[b][3] = Iw[1][1] + m * (c2 - cw[1] * cw[1]);
    Ab[b][4] = Iw[1][2] - m * cw[1] * cw[2];
    Ab[b][5] = Iw[2][2] + m * (c2 - cw[2] * cw[2]);
    sb[b] = m;
    for (int k = 0; k < 3; ++k) hb[b][k] = cw[k] * m;
  }

  // ---------------- 3. CRBA mass matrix ----------------
  float sc[NB], hc[NB][3], Ac[NB][6];
  for (int b = 0; b < NB; ++b) {
    sc[b] = sb[b];
    for (int k = 0; k < 3; ++k) hc[b][k] = hb[b][k];
    for (int k = 0; k < 6; ++k) Ac[b][k] = Ab[b][k];
  }
#pragma unroll 1
  for (int b = NB - 1; b > 0; --b) {
    const int p = (int)mdl[OFF_PARENT + b];
    sc[p] += sc[b];
    for (int k = 0; k < 3; ++k) hc[p][k] += hc[b][k];
    for (int k = 0; k < 6; ++k) Ac[p][k] += Ac[b][k];
  }
  // M holds the mass matrix, then its Cholesky factor in the strict lower
  // triangle, then (step 4) the inverse G.  u order: [v0, w0, qd].
  float M[NV][NV];
  for (int i = 0; i < NV; ++i)
    for (int j = 0; j < NV; ++j) M[i][j] = 0.0f;  // uncoupled pairs stay exact zeros
  {
    const float* h0 = hc[0];
    const float skh[3][3] = {{0.0f, -h0[2], h0[1]}, {h0[2], 0.0f, -h0[0]}, {-h0[1], h0[0], 0.0f}};
    for (int i = 0; i < 3; ++i) {
      M[i][i] = sc[0];
      for (int j = 0; j < 3; ++j) {
        M[i][3 + j] = M[3 + j][i] = -skh[i][j];
        M[3 + i][3 + j] = s6(Ac[0], i, j);
      }
    }
  }
#pragma unroll 1
  for (int j = 0; j < ND; ++j) {
    const int b = j + 1;
    float Ft[3], Fb[3];
    inertia_apply(sc[b], hc[b], Ac[b], phw[j], phv[j], Ft, Fb);
    for (int i = 0; i < 3; ++i) {
      M[i][6 + j] = M[6 + j][i] = Fb[i];          // v rows take the linear part
      M[3 + i][6 + j] = M[6 + j][3 + i] = Ft[i];  // w rows take the angular part
    }
    for (int k = 0; k <= j; ++k) {
      if (mdl[OFF_ANC + b * ND + k] == 0.0f) continue;
      const float val = dot3(Ft, phw[k]) + dot3(Fb, phv[k]);
      M[6 + k][6 + j] = M[6 + j][6 + k] = val;
    }
  }
  for (int i = 0; i < NV; ++i) M[i][i] += cfg[CFG_REG];

  // ---------------- 4. Cholesky inverse ----------------
  float Li[NV][NV], idg[NV];
#pragma unroll 1
  for (int i = 0; i < NV; ++i) {
    float s = M[i][i];
    for (int k = 0; k < i; ++k) s -= M[i][k] * M[i][k];
    const float d = rsqrtf(s);
    idg[i] = d;
    for (int j = i + 1; j < NV; ++j) {
      float t = M[j][i];
      for (int k = 0; k < i; ++k) t -= M[j][k] * M[i][k];
      M[j][i] = t * d;
    }
  }
#pragma unroll 1
  for (int i = 0; i < NV; ++i) {
    Li[i][i] = idg[i];
    for (int j = i + 1; j < NV; ++j) {
      float t = M[j][i] * Li[i][i];
      for (int k = i + 1; k < j; ++k) t += M[j][k] * Li[k][i];
      Li[j][i] = -t * idg[j];
    }
  }
  float (*G)[NV] = M;  // M^-1 = L^-T L^-1 overwrites M
#pragma unroll 1
  for (int i = 0; i < NV; ++i)
    for (int j = i; j < NV; ++j) {
      float t = Li[j][i] * Li[j][j];
      for (int k = j + 1; k < NV; ++k) t += Li[k][i] * Li[k][j];
      G[i][j] = G[j][i] = t;
    }

  // ---------------- 5. RNEA bias + free velocity ----------------
  float uf[NV];
  {
    float vw[NB][3], vv[NB][3], aw[NB][3], av[NB][3];
    for (int k = 0; k < 3; ++k) {
      vw[0][k] = w0[k];
      vv[0][k] = v0[k];
      aw[0][k] = 0.0f;
    }
    av[0][0] = -cfg[CFG_GX];
    av[0][1] = -cfg[CFG_GY];
    av[0][2] = -cfg[CFG_GZ];
#pragma unroll 1
    for (int b = 1; b < NB; ++b) {
      const int p = (int)mdl[OFF_PARENT + b];
      float mw[3], mv[3], t1[3], t2[3], t3[3];
      for (int k = 0; k < 3; ++k) {
        vw[b][k] = vw[p][k] + phw[b - 1][k] * qd[b - 1];
        vv[b][k] = vv[p][k] + phv[b - 1][k] * qd[b - 1];
        mw[k] = phw[b - 1][k] * qd[b - 1];
        mv[k] = phv[b - 1][k] * qd[b - 1];
      }
      cross3(vw[b], mw, t1);
      cross3(vv[b], mw, t2);
      cross3(vw[b], mv, t3);
      for (int k = 0; k < 3; ++k) {
        aw[b][k] = aw[p][k] + t1[k];
        av[b][k] = av[p][k] + (t2[k] + t3[k]);
      }
    }
    // body forces, written over the accelerations
#pragma unroll 1
    for (int b = 0; b < NB; ++b) {
      float Iat[3], Iab[3], Ivt[3], Ivb[3], c1[3], c2[3], c3[3];
      inertia_apply(sb[b], hb[b], Ab[b], aw[b], av[b], Iat, Iab);
      inertia_apply(sb[b], hb[b], Ab[b], vw[b], vv[b], Ivt, Ivb);
      cross3(vw[b], Ivt, c1);
      cross3(vv[b], Ivb, c2);
      cross3(vw[b], Ivb, c3);
      for (int k = 0; k < 3; ++k) {
        aw[b][k] = Iat[k] + (c1[k] + c2[k]);
        av[b][k] = Iab[k] + c3[k];
      }
    }
#pragma unroll 1
    for (int b = NB - 1; b > 0; --b) {
      const int p = (int)mdl[OFF_PARENT + b];
      for (int k = 0; k < 3; ++k) {
        aw[p][k] += aw[b][k];
        av[p][k] += av[b][k];
      }
    }
    float rhs[NV], udot[NV];
    for (int k = 0; k < 3; ++k) {
      rhs[k] = ext[k] - av[0][k];
      rhs[3 + k] = ext[3 + k] - aw[0][k];
    }
    for (int j = 0; j < ND; ++j)
      rhs[6 + j] = tau[j] - (dot3(phw[j], aw[j + 1]) + dot3(phv[j], av[j + 1]));
    minv_vec(G, rhs, udot);
    for (int k = 0; k < 3; ++k) {
      uf[k] = v0[k] + dt * udot[k];
      uf[3 + k] = w0[k] + dt * udot[3 + k];
    }
    for (int j = 0; j < ND; ++j) uf[6 + j] = qd[j] + dt * udot[6 + j];
  }

  // ---------------- 6. per-body Lambda_b = J_b G J_b^T ----------------
  // spatial rows [w; v]; J_b's base block maps u row swap6(r) to row r
  float Lam[NB][6][6];
#pragma unroll 1
  for (int b = 0; b < NB; ++b) {
    float X[6][NV];
    const float* anc = mdl + OFF_ANC + b * ND;
    for (int r = 0; r < 6; ++r)
      for (int c = 0; c < NV; ++c) X[r][c] = G[swap6(r)][c];
#pragma unroll 1
    for (int j = 0; j < ND; ++j) {
      if (anc[j] == 0.0f) continue;
      const float ph6[6] = {phw[j][0], phw[j][1], phw[j][2], phv[j][0], phv[j][1], phv[j][2]};
      for (int r = 0; r < 6; ++r)
        for (int c = 0; c < NV; ++c) X[r][c] += ph6[r] * G[6 + j][c];
    }
    for (int rr = 0; rr < 6; ++rr)
      for (int ss = rr; ss < 6; ++ss) {
        float val = X[rr][swap6(ss)];
        for (int j = 0; j < ND; ++j) {
          if (anc[j] == 0.0f) continue;
          const float phs = ss < 3 ? phw[j][ss] : phv[j][ss - 3];
          val += X[rr][6 + j] * phs;
        }
        Lam[b][rr][ss] = Lam[b][ss][rr] = val;
      }
  }

  // ---------------- 7. per-point Delassus blocks and targets -------------
  float pr[NPT][3], pdepth[NPT], pact[NPT], counts[NB];
  for (int b = 0; b < NB; ++b) counts[b] = 0.0f;
#pragma unroll 1
  for (int p = 0; p < NPT; ++p) {
    const int b = (int)mdl[OFF_PBODY + p];
    float wp[3];
    mv33(R[b], mdl + OFF_PPOS + 3 * p, wp);
    for (int k = 0; k < 3; ++k) {
      wp[k] += P[b][k];
      pr[p][k] = wp[k] - p0[k];
    }
#if PLANE
    pdepth[p] = mdl[OFF_PRAD + p] - wp[2];
#else
    pdepth[p] = IN(h_in, p) + mdl[OFF_PRAD + p] - wp[2];
    IN(ptxy_out, 2 * p) = wp[0];
    IN(ptxy_out, 2 * p + 1) = wp[1];
#endif
    pact[p] = pdepth[p] > -cfg[CFG_MARGIN] ? 1.0f : 0.0f;
    counts[b] += pact[p];
  }
  float bw[NB][3], bv[NB][3];
  body_velocities(mdl, uf, phw, phv, bw, bv);
  float Dinv[NPT][9], pmu[NPT], vtz[NPT];
#pragma unroll 1
  for (int p = 0; p < NPT; ++p) {
    const int b = (int)mdl[OFF_PBODY + p];
    const float* r = pr[p];
    float Lww[3][3], Lwv[3][3], Lvw[3][3], Lvv[3][3], t0[3][3], t1[3][3], t2[3][3], t3[3][3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        Lww[i][j] = Lam[b][i][j];
        Lwv[i][j] = Lam[b][i][3 + j];
        Lvw[i][j] = Lam[b][3 + i][j];
        Lvv[i][j] = Lam[b][3 + i][3 + j];
      }
    // skew(r) @ A (rows) and A @ skew(r) (columns)
    for (int j = 0; j < 3; ++j) {
      t0[0][j] = r[1] * Lww[2][j] - r[2] * Lww[1][j];
      t0[1][j] = r[2] * Lww[0][j] - r[0] * Lww[2][j];
      t0[2][j] = r[0] * Lww[1][j] - r[1] * Lww[0][j];
      t2[0][j] = r[1] * Lwv[2][j] - r[2] * Lwv[1][j];
      t2[1][j] = r[2] * Lwv[0][j] - r[0] * Lwv[2][j];
      t2[2][j] = r[0] * Lwv[1][j] - r[1] * Lwv[0][j];
    }
    for (int i = 0; i < 3; ++i) {
      t1[i][0] = t0[i][1] * r[2] - t0[i][2] * r[1];
      t1[i][1] = t0[i][2] * r[0] - t0[i][0] * r[2];
      t1[i][2] = t0[i][0] * r[1] - t0[i][1] * r[0];
      t3[i][0] = Lvw[i][1] * r[2] - Lvw[i][2] * r[1];
      t3[i][1] = Lvw[i][2] * r[0] - Lvw[i][0] * r[2];
      t3[i][2] = Lvw[i][0] * r[1] - Lvw[i][1] * r[0];
    }
    const float split = fmaxf(counts[b], 1.0f);
    float D[9];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        D[3 * i + j] = (Lvv[i][j] - t1[i][j] - t2[i][j] + t3[i][j]) * split + (i == j ? 1e-8f : 0.0f);
    const float a = D[0], b_ = D[1], c = D[2], d_ = D[3], e_ = D[4], f_ = D[5], g = D[6],
                h = D[7], i_ = D[8];
    const float co_a = e_ * i_ - f_ * h, co_b = c * h - b_ * i_, co_c = b_ * f_ - c * e_;
    const float idet = 1.0f / (a * co_a + d_ * co_b + g * co_c);
    float* Di = Dinv[p];
    Di[0] = co_a * idet; Di[1] = co_b * idet; Di[2] = co_c * idet;
    Di[3] = (f_ * g - d_ * i_) * idet; Di[4] = (a * i_ - c * g) * idet; Di[5] = (c * d_ - a * f_) * idet;
    Di[6] = (d_ * h - e_ * g) * idet; Di[7] = (b_ * g - a * h) * idet; Di[8] = (a * e_ - b_ * d_) * idet;
    const int sh = (int)mdl[OFF_PSHAPE + p];
    pmu[p] = 0.5f * (IN(dyn, 10 * NB + sh) + cfg[CFG_TFRIC]);
    const float rest = 0.5f * (IN(dyn, 10 * NB + NS + sh) + cfg[CFG_TREST]);
    float wxr[3];
    cross3(bw[b], r, wxr);
#if PLANE
    const float vn_pre = bv[b][2] + wxr[2];
#else
    const float vz = bv[b][2] + wxr[2];
    const float vn_pre = (bv[b][0] + wxr[0]) * IN(n_in, 3 * p)
                         + (bv[b][1] + wxr[1]) * IN(n_in, 3 * p + 1) + vz * IN(n_in, 3 * p + 2);
#endif
    const float pushout = fminf(cfg[CFG_BAUMGARTE] * fmaxf(pdepth[p] - cfg[CFG_SLOP], 0.0f) / dt,
                                cfg[CFG_MAX_PUSHOUT]);
    const float bounce = vn_pre < -cfg[CFG_BOUNCE] ? -rest * vn_pre : 0.0f;
    vtz[p] = fmaxf(pushout, bounce);  // K5: the target's length along n
  }

  // ---------------- 8. Jacobi sweeps, friction cone about +z (K5: n) -----
  float lam[NPT][3], wt[NB][3], wf[NB][3], du[NV], un[NV];
  for (int p = 0; p < NPT; ++p) lam[p][0] = lam[p][1] = lam[p][2] = 0.0f;
  const int iters = (int)cfg[CFG_ITERS];
  const float relax = cfg[CFG_RELAX];
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    wrench_and_du(mdl, lam, pr, phw, phv, G, wt, wf, du);
    for (int i = 0; i < NV; ++i) un[i] = uf[i] + du[i];
    body_velocities(mdl, un, phw, phv, bw, bv);
#pragma unroll 1
    for (int p = 0; p < NPT; ++p) {
      const int b = (int)mdl[OFF_PBODY + p];
      float wxr[3];
      cross3(bw[b], pr[p], wxr);
#if PLANE
      const float dv[3] = {-(bv[b][0] + wxr[0]), -(bv[b][1] + wxr[1]), vtz[p] - (bv[b][2] + wxr[2])};
#else
      const float nrm[3] = {IN(n_in, 3 * p), IN(n_in, 3 * p + 1), IN(n_in, 3 * p + 2)};
      // The target vtz n minus the point velocity v, in K1's shape
      // (-vx, -vy, vtz - vz) with the target's part off +z, vtz (n - z),
      // taken out of v first.  nvcc sums D^-1 dv in another order when dv's
      // x and y are not negations, which breaks the bitwise equality with
      // K1; in this shape they are, and on plane inputs that part is
      // exactly 0.
      const float dv[3] = {-((bv[b][0] + wxr[0]) - __fmul_rn(nrm[0], vtz[p])),
                           -((bv[b][1] + wxr[1]) - __fmul_rn(nrm[1], vtz[p])),
                           vtz[p] - ((bv[b][2] + wxr[2]) + __fmul_rn(1.0f - nrm[2], vtz[p]))};
#endif
      const float* Di = Dinv[p];
      float ln[3];
      for (int k = 0; k < 3; ++k)
        ln[k] = lam[p][k] + relax * (Di[3 * k] * dv[0] + Di[3 * k + 1] * dv[1] + Di[3 * k + 2] * dv[2]);
      const float a = pact[p];
#if PLANE
      const float lz = fmaxf(ln[2], 0.0f);
      const float lt = sqrtf(ln[0] * ln[0] + ln[1] * ln[1] + 1e-18f);
      const float scale = fminf(1.0f, pmu[p] * lz / lt);
      lam[p][0] = ln[0] * scale * a;
      lam[p][1] = ln[1] * scale * a;
      lam[p][2] = lz * a;
#else
      // cone about the terrain normal: normal part clamped at 0, tangential
      // part scaled into the cone
      const float ldn = ln[0] * nrm[0] + ln[1] * nrm[1] + ln[2] * nrm[2];
      const float lz = fmaxf(ldn, 0.0f);
      const float ltv[3] = {ln[0] - ldn * nrm[0], ln[1] - ldn * nrm[1], ln[2] - ldn * nrm[2]};
      const float lt = sqrtf(ltv[0] * ltv[0] + ltv[1] * ltv[1] + ltv[2] * ltv[2] + 1e-18f);
      const float scale = fminf(1.0f, pmu[p] * lz / lt);
      for (int k = 0; k < 3; ++k) lam[p][k] = (nrm[k] * lz + ltv[k] * scale) * a;
#endif
    }
  }
  wrench_and_du(mdl, lam, pr, phw, phv, G, wt, wf, du);
  for (int i = 0; i < NV; ++i) un[i] = uf[i] + du[i];

  // ---------------- 9. integrate ----------------
  float vnew[3], wxv[3];
  cross3(w0, v0, wxv);
  for (int k = 0; k < 3; ++k) {
    vnew[k] = un[k] + dt * wxv[k];
    IN(s_out, k) = p0[k] + dt * vnew[k];
    IN(s_out, 7 + k) = vnew[k];
    IN(s_out, 10 + k) = un[3 + k];
  }
  {
    const float wx = un[3], wy = un[4], wz = un[5];
    const float ang = sqrtf(wx * wx + wy * wy + wz * wz + 1e-18f);
    const float half = 0.5f * dt * ang;
    const float sc_ = sinf(half) / ang, dw = cosf(half);
    const float dx = wx * sc_, dy = wy * sc_, dz = wz * sc_;
    const float qw = quat[0], qx = quat[1], qy = quat[2], qz = quat[3];
    const float nqw = dw * qw - dx * qx - dy * qy - dz * qz;
    const float nqx = dw * qx + dx * qw + dy * qz - dz * qy;
    const float nqy = dw * qy - dx * qz + dy * qw + dz * qx;
    const float nqz = dw * qz + dx * qy - dy * qx + dz * qw;
    const float norm = rsqrtf(nqw * nqw + nqx * nqx + nqy * nqy + nqz * nqz);
    IN(s_out, 3) = nqw * norm;
    IN(s_out, 4) = nqx * norm;
    IN(s_out, 5) = nqy * norm;
    IN(s_out, 6) = nqz * norm;
  }
  for (int j = 0; j < ND; ++j) {
    float qdn = un[6 + j];
    const float qn = q[j] + dt * qdn;
    const float lo = mdl[OFF_LO + j], hi = mdl[OFF_HI + j];
    if (qn < lo) qdn = fmaxf(qdn, 0.0f);
    if (qn > hi) qdn = fminf(qdn, 0.0f);
    IN(s_out, 13 + j) = fminf(fmaxf(qn, lo), hi);
    IN(s_out, 13 + ND + j) = qdn;
  }
  for (int b = 0; b < NB; ++b)
    for (int k = 0; k < 3; ++k) IN(f_out, 3 * b + k) = wf[b][k] / dt;

  // ---------------- 10. feet poses from the start-of-substep FK ----------
  for (int fi = 0; fi < NF; ++fi) {
    const int b = (int)mdl[OFF_FEET + fi];
    for (int k = 0; k < 3; ++k) IN(feet_out, 12 * fi + k) = P[b][k];
    for (int k = 0; k < 9; ++k) IN(feet_out, 12 * fi + 3 + k) = R[b][k];
  }
#undef IN
}

// Plain C entry point for ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it never synchronizes.
#if PLANE
extern "C" int bg_substep(const float* s_in, const float* dyn, const float* tau,
                          const float* ext, const float* mdl, float* s_out, float* f_out,
                          float* feet_out, int B, void* stream) {
  if (B <= 0) return 0;
  const int grid = (B + BLOCK - 1) / BLOCK;
  substep_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(s_in, dyn, tau, ext, mdl, s_out, f_out,
                                                           feet_out, B);
  return (int)cudaGetLastError();
}
#else
extern "C" int bg_substep_terrain(const float* s_in, const float* dyn, const float* tau,
                                  const float* ext, const float* h_in, const float* n_in,
                                  const float* mdl, float* s_out, float* f_out,
                                  float* feet_out, float* ptxy_out, int B, void* stream) {
  if (B <= 0) return 0;
  const int grid = (B + BLOCK - 1) / BLOCK;
  substep_kernel<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(s_in, dyn, tau, ext, h_in, n_in,
                                                           ptxy_out, mdl, s_out, f_out,
                                                           feet_out, B);
  return (int)cudaGetLastError();
}
#endif
