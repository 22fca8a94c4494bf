// The fused PPO update for Hopper (sm_90a): K2, K3 and K4, and the rest of
// the reference's FusedUpdate, K8, K9 and K10.
//
//   K2  bg_gae            replaces booster_gym_tpu/algo/update_kernel.py _gae_kernel
//   K3  bg_grads_stats    replaces _grads_stats_kernel (_mlp_fwd_T, _mlp_bwd_T)
//   K4  bg_opt_stage      replaces _opt_stage_kernel
//   K8  bg_values         replaces _values_kernel: K2's critic kernel on any
//                         rows, without the walk
//   K9  bg_grads          replaces _grads_kernel: K3's passes without the
//                         metric sums and the normalisation, n_total apart
//                         from the row count, mu and values out in type T
//   K10 bg_policy_logp    replaces _policy_logp_kernel: K3's actor forward and
//                         log-prob, through the same device code
//
// K8-K10 share K2's and K3's device code, so their bounds and their gaps to
// them are K2's and K3's: K8 is K2's forward-only critic kernel (k2_critic)
// without the walk, bound by operations like K2 (the critic's 2.3e5 flop per
// row); K10 runs K3's net_fwd and log-prob (the actor's 1.3e5 flop per row),
// K9 K3's passes.
//
// Each has a bf16 and an f32 instance (the network's compute type T).  In
// f32 mode the matrix products are f32 FMAs, never TF32.  In bf16 mode they
// go to the tensor cores as mma.sync.m16n8k16 (bf16 operands from shared
// memory through ldmatrix, f32 accumulators in registers, whose layout PTX
// documents, so every epilogue reads its results straight from them): a bf16
// x bf16 product is exact in f32, so with f32 accumulation both are the
// reference's arithmetic up to summation order.
//
// Layouts.  Everything is batch-major.  `obsc` is [rows, NOBS + NPRIV] of
// type T, the actor's observation being its first NOBS columns.  Parameters,
// gradients and Adam moments are flat f32 vectors in the order of the
// PyTorch module's parameters, weights [out, in]; `staged` is the same
// vector in type T.  `offs` gives the 17 offsets into it: actor weights
// (4), actor biases (4), critic weights (4), critic biases (4), logstd.
// Each launch first copies the weights of `staged` into `wpad` (k_pad):
// every layer [rup16(out)][rup16(in)], zero-padded, so that a row of 8
// values is 16 aligned bytes that cp.async can fetch; a tile block's launch
// (K3, K9, K10) also each layer's transpose [rup16(in)][rup16(out)] after
// them, so that every weight chunk it stages is whole rows of one
// row-major matrix, read the same way.
//
// What bounds them on this card.  K2 and K3 are bound by operations
// (2.3e5 and 1.0e6 flop per sample against 0.1 to 0.4 KB).  K2 and K8 run
// their own forward-only critic kernel, k2_critic (its design is at the
// kernel).  K3's tile block (one per SM; also K10's) keeps one tile of
// samples (64 in bf16, 32 in f32 at the T1 networks' widths; tile_rows
// halves it where the block would not fit, 32 and 16 at T1Standup's
// 434-wide critic input) with every layer's activations in shared memory,
// and is warp-specialised: a producer warp streams the weights from L2 in
// chunks of 16 or 32 reduction rows through a ring of mbarrier-guarded
// stages, as deep as the block's shared memory leaves room for, to two
// groups of 8 warps, each taking half of every tile's rows (its schedule is
// at gemm_epi).  K3 (and K9) is three passes, all on the caller's stream:
//   pass 1 (k3_pass1)  per tile: forward, the per-row loss step, the input
//                      gradients of both nets; every layer's input x_l and
//                      output gradient dz_l leave as rows in type T, 16
//                      bytes a thread and store, to a scratch in device
//                      memory (2,400 values per row at the T1 widths), and
//                      the per-row stats to the block's stat partial;
//   pass 2 (k3_pass2)  the weight gradients dW_l = dz_l^T x_l as a split-K
//                      product over the rows: a block owns one 128 x 128
//                      tile of one layer's dW and one slab of rows
//                      (thousands), keeps the tile's f32 sums in registers
//                      across the whole slab, and writes them once into the
//                      slab's partial; db_l from the same tiles, a
//                      fixed-order row sum;
//   pass 3 (k3_reduce) the slab partials added in slab order.
// The weight gradient is thus never added to device memory per tile (the
// design before this one did: 273 M L2 reductions per call on 94 MB of
// partials, most of its 4.7 ms).  What bounds K3 now is still pass 1, ~75 %
// of a call.  A consumer warp's tile at the T1 widths (-DK3_CLOCKS=1,
// NVIDIA H100 80GB HBM3, 700 W) is ~37 % products, ~21 % scratch stores
// (1.9 GB a call at 393,216 rows), ~18 % waits on a full stage, ~12 %
// epilogues (ELU's exp for every value) and ~7 % group barriers.  Each tile
// restages all weights from L2 (~0.7 MB per 64 rows) through a ring only 3
// stages deep at the T1 widths, and a stage frees only when both groups
// have read it: the ring stays full, the groups run nearly together, and
// one's epilogue seldom runs under the other's products.  Then pass 2's
// reads of the scratch.
// K4 is bound by bytes (four vectors read, four written); it is one launch
// (k4_opt, its design is at the kernel).
//
// Sums across blocks are deterministic: each pass-1 block owns a fixed set
// of tiles and adds their stats in a fixed order into its own partial, each
// pass-2 block owns one tile of one slab, and the reduce adds the partials in
// block or slab order; K2's blocks each own a fixed set of envs, and its last
// block adds their partials in block order.  No float atomic adds anywhere.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#ifndef NOBS
#define NOBS 47
#endif
#ifndef NPRIV
#define NPRIV 14
#endif
#ifndef NACT
#define NACT 12
#endif
#ifndef AH1
#define AH1 256
#endif
#ifndef AH2
#define AH2 128
#endif
#ifndef AH3
#define AH3 128
#endif
#ifndef CH1
#define CH1 256
#endif
#ifndef CH2
#define CH2 256
#endif
#ifndef CH3
#define CH3 128
#endif

// (host and device: the kernels call them with run-time arguments too)
#define HD __host__ __device__
constexpr HD int cmax(int a, int b) { return a > b ? a : b; }
constexpr HD int rup(int x, int m) { return (x + m - 1) / m * m; }
constexpr int NCRIT = NOBS + NPRIV;
// A tile block (one per SM): NG warp groups of NWG consumer warps, then one
// producer warp
constexpr int NG = 2, NWG = 8, GT = NWG * 32;  // groups, warps and threads a group
constexpr int NW = NG * NWG;                  // consumer warps
constexpr int NT = NG * GT + 32;              // threads of a tile block
constexpr int K4_NT = 256;                    // threads of K4's blocks and the reduce
constexpr int X0W = rup(NCRIT, 32);           // padded input width
constexpr int DZ3W = rup(NACT, 16);           // padded width of the last layer's dz
constexpr int NSTAT = rup(4 + 2 * NACT, 32);  // per-sample stat slots (4 + 2 NACT used)
constexpr int HB1 = cmax(AH1, CH1), HB2 = cmax(AH2, CH2), HB3 = cmax(AH3, CH3);
constexpr int HBA = cmax(HB1, HB3);           // the x buffer of layers 1 and 3
constexpr float LOG2PI = 1.8378770664093453f;
constexpr size_t SMEM_MAX = 232448;           // a block's shared memory on the H100
// every layer's bias, in a tile block's shared memory: the actor's four,
// then the critic's
constexpr int NB_ACTOR = AH1 + AH2 + AH3 + NACT, NBIAS = NB_ACTOR + CH1 + CH2 + CH3 + 1;

static_assert(AH1 % 32 == 0 && AH2 % 32 == 0 && AH3 % 32 == 0, "hidden widths: multiples of 32");
static_assert(CH1 % 32 == 0 && CH2 % 32 == 0 && CH3 % 32 == 0, "hidden widths: multiples of 32");
static_assert(HB1 <= 256 && HB2 <= 256 && HB3 <= 256, "hidden widths: at most 256");

struct Offs { int aW[4], ab[4], cW[4], cb[4], logstd; };

// The bytes of a tile block's shared memory (Smem<T>::bytes, which
// static_asserts the two equal) at tn samples a tile, for a compute type of
// tsize bytes with a ring of st stages of kc reduction rows and CT's pad:
// the activations, the ring, the biases, the f32 rows, then a full and an
// empty mbarrier a stage
constexpr size_t tile_bytes(int tn, int kc, int st, int pad, int tsize) {
    const int n_ws = kc * (256 + pad);
    const size_t n_t = (size_t)tn * (X0W + HB1 + HB2 + HB3 + HBA + HB2 + 6 * pad) + st * n_ws
                       + rup(NBIAS, 8);
    const size_t n_f = (size_t)tn * (NACT + 1 + NSTAT) + 2 * NACT;
    return ((n_t * tsize + 127) / 128) * 128 + n_f * 4 + 16 * st;
}
// A tile's samples: tn, halved while the block with a ring of two stages of
// 32 (bf16) or 16 (f32) rows does not fit (down to 16).  The T1 networks
// keep 64 in bf16 and 32 in f32; a 434-wide critic input takes 32 and 16.
constexpr int tile_rows(int tn, int kc, int st, int pad, int tsize) {
    return tn <= 16 || tile_bytes(tn, kc, st, pad, tsize) <= SMEM_MAX
               ? tn : tile_rows(tn / 2, kc, st, pad, tsize);
}
// The ring's stages: as many chunks of kc rows as the rest of the block
// leaves room for
constexpr int ring_stages(int tn, int kc, int pad, int tsize, int st = 1) {
    return tile_bytes(tn, kc, st + 1, pad, tsize) <= SMEM_MAX ? ring_stages(tn, kc, pad, tsize, st + 1)
                                                              : st;
}

template <typename T> struct CT;
// TN: samples in a tile (tile_rows); KC: reduction rows of a staged weight
// chunk, ST of them in the ring (ring_stages: 3 in bf16 at the T1 widths, 7
// at T1Standup's; chunks of 16 rows in bf16, twice the stages, measured
// 1-4 % slower at the T1 widths, NVIDIA H100 80GB HBM3, 700 W); PAD: what
// a shared-memory row stride adds to its width (multiples of 16 bytes, and
// for bf16 an odd number of 16-byte units, so the 8 rows an ldmatrix reads
// fall in different banks); VEC: values in 16 bytes
template <> struct CT<float> {
    static constexpr int KC = 16, PAD = 4, VEC = 4;
    static constexpr int TN = tile_rows(32, KC, 2, PAD, 4);
    static constexpr int ST = ring_stages(TN, KC, PAD, 4);
    static __device__ __forceinline__ float to_f(float x) { return x; }
    static __device__ __forceinline__ float from_f(float x) { return x; }
};
template <> struct CT<__nv_bfloat16> {
    static constexpr int KC = 32, PAD = 8, VEC = 8;
    static constexpr int TN = tile_rows(64, KC, 2, PAD, 2);
    static constexpr int ST = ring_stages(TN, KC, PAD, 2);
    static __device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
    static __device__ __forceinline__ __nv_bfloat16 from_f(float x) { return __float2bfloat16_rn(x); }
};
// ---- end of the build's sizes: from `#ifndef NOBS` to here the text is
// plain C++ but for the CUDA qualifiers and the bf16 type

// x rounded to T, as a float
template <typename T> __device__ __forceinline__ float rnd(float x) {
    return CT<T>::to_f(CT<T>::from_f(x));
}

// A net's widths, and where each layer's padded weights [rup16(out)][rup16(in)]
// lie in wpad (the actor's first, then the critic's)
template <int D0_, int H1_, int H2_, int H3_, int DO_, int BASE> struct NetDims {
    static constexpr int D0 = D0_, H1 = H1_, H2 = H2_, H3 = H3_, DO = DO_;
    static constexpr HD int in(int l) { return l == 0 ? D0 : l == 1 ? H1 : l == 2 ? H2 : H3; }
    static constexpr HD int out(int l) { return l == 0 ? H1 : l == 1 ? H2 : l == 2 ? H3 : DO; }
    static constexpr HD int inp(int l) { return rup(in(l), 16); }
    static constexpr HD int outp(int l) { return rup(out(l), 16); }
    static constexpr HD int wp(int l) {
        return l == 0 ? BASE : wp(l - 1) + outp(l - 1) * inp(l - 1);
    }
    // the first l hidden widths added (l <= 3)
    static constexpr HD int hsum(int l) { return l == 0 ? 0 : hsum(l - 1) + out(l - 1); }
    static constexpr int end = wp(4);
};
using ActorNet = NetDims<NOBS, AH1, AH2, AH3, NACT, 0>;
using CriticNet = NetDims<NCRIT, CH1, CH2, CH3, 1, ActorNet::end>;
constexpr int NWPAD = CriticNet::end;
template <typename Net> constexpr HD int bias_off(int l) {
    return (std::is_same<Net, ActorNet>::value ? 0 : NB_ACTOR) + Net::hsum(l);
}

// The pass-1 scratch: per net and layer l, x_l [n][width] (l >= 1; x_0 is
// shared, [n][X0W]) and dz_l [n][width], in this order: x0, then for the
// actor and then the critic x1, x2, x3, dz0, dz1, dz2, dz3 (dz3 DZ3W wide).
// Offsets in rows of n.  This is the layout's one definition: bg_update_info
// reports it, and the wrapper cuts its views of the scratch by that.
template <typename Net> struct ScratchOf {
    static constexpr HD int x(int l) { return Net::hsum(l - 1); }
    static constexpr HD int dz(int l) { return Net::hsum(3) + Net::hsum(l); }
    static constexpr int width = 2 * Net::hsum(3) + DZ3W;
};
constexpr int SCR_ACTOR = X0W, SCR_CRITIC = X0W + ScratchOf<ActorNet>::width;
constexpr int SCR_WIDTH = SCR_CRITIC + ScratchOf<CriticNet>::width;   // values per row
template <typename Net> constexpr HD int scr_base() {
    return std::is_same<Net, ActorNet>::value ? SCR_ACTOR : SCR_CRITIC;
}
template <typename Net> constexpr HD int scr_x(int l) {
    return l == 0 ? 0 : scr_base<Net>() + ScratchOf<Net>::x(l);
}
template <typename Net> constexpr HD int scr_dz(int l) {
    return scr_base<Net>() + ScratchOf<Net>::dz(l);
}
template <typename Net> constexpr HD int scr_xw(int l) { return l == 0 ? X0W : Net::in(l); }
template <typename Net> constexpr HD int scr_dzw(int l) { return l == 3 ? DZ3W : Net::out(l); }

// ---------------------------------------------------------------------------
// Shared memory of a tile block (K3's pass 1, K10).  Row strides are the
// widths plus PAD.  The x of layers 1 and 3 share xa; z_l holds ELU' of the
// pre-activation and then, in the backward, dz of that layer; the last
// layer's dz (dzl) lies in xb, free once the forward is done.  Warp group g
// owns rows [g TG, + TG) of every row buffer.
template <typename T> struct Smem {
    static constexpr int TN = CT<T>::TN, TG = TN / NG, P = CT<T>::PAD, ST = CT<T>::ST;
    static constexpr int L0 = X0W + P, LZ1 = HB1 + P, LZ2 = HB2 + P, LZ3 = HB3 + P, LA = HBA + P,
                         LB = HB2 + P, LD = DZ3W + P;
    // a staged chunk: [KC][CW + PAD] (CW <= 256), ST of them
    static constexpr int n_ws = CT<T>::KC * (256 + P);
    static constexpr size_t n_t = (size_t)TN * (L0 + LZ1 + LZ2 + LZ3 + LA + LB) + ST * n_ws
                                  + rup(NBIAS, 8);
    static constexpr size_t n_f = (size_t)TN * (NACT + 1 + NSTAT) + 2 * NACT;
    static constexpr size_t f_off = ((n_t * sizeof(T) + 127) / 128) * 128;
    static constexpr size_t bar_off = f_off + n_f * sizeof(float);
    static constexpr size_t bytes = bar_off + 16 * ST;
    T *x0, *z1, *z2, *z3, *xa, *xb, *dzl, *ws, *bias;
    float *mu, *val, *stat, *logstd, *var;
    unsigned long long* bar;   // the ring's mbarriers: full[ST], then empty[ST]
    __device__ Smem(unsigned char* raw) {
        bar = reinterpret_cast<unsigned long long*>(raw + bar_off);
        T* p = reinterpret_cast<T*>(raw);
        x0 = p; p += TN * L0;
        z1 = p; p += TN * LZ1;
        z2 = p; p += TN * LZ2;
        z3 = p; p += TN * LZ3;
        xa = p; p += TN * LA;
        xb = p; p += TN * LB;
        dzl = xb;
        ws = p; p += ST * n_ws;
        bias = p;
        float* f = reinterpret_cast<float*>(raw + f_off);
        mu = f; f += TN * NACT;
        val = f; f += TN;
        stat = f; f += TN * NSTAT;
        logstd = f; f += NACT;
        var = f;
    }
};
static_assert(Smem<float>::bytes <= SMEM_MAX, "f32 tile exceeds a block's shared memory");
static_assert(Smem<__nv_bfloat16>::bytes <= SMEM_MAX, "bf16 tile exceeds a block's shared memory");
static_assert(Smem<float>::bytes == tile_bytes(CT<float>::TN, 16, CT<float>::ST, 4, 4)
              && Smem<__nv_bfloat16>::bytes
                     == tile_bytes(CT<__nv_bfloat16>::TN, CT<__nv_bfloat16>::KC,
                                   CT<__nv_bfloat16>::ST, 8, 2),
              "tile_bytes must be Smem's size");
static_assert(Smem<float>::LD <= Smem<float>::LB && Smem<__nv_bfloat16>::LD <= Smem<__nv_bfloat16>::LB,
              "dzl must fit in xb");
static_assert(Smem<float>::bar_off % 8 == 0 && Smem<__nv_bfloat16>::bar_off % 8 == 0,
              "mbarriers are 8-byte aligned");
static_assert(CT<float>::ST >= 2 && CT<__nv_bfloat16>::ST >= 2, "a ring of two stages at least");
static_assert(Smem<__nv_bfloat16>::TG % 16 == 0 && Smem<float>::TG % NWG == 0,
              "a group's rows: whole 16-row mma tiles (bf16), whole rows a warp (f32)");

// ---------------------------------------------------------------------------
// PTX: cp.async (16 or 4 bytes; src_bytes 0 fills zeros), ldmatrix, mbarriers, mma.sync
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}
// Shared memory by address, for the bf16 epilogues (gemm_epi)
__device__ __forceinline__ uint32_t lds_b32(uint32_t a) {
    uint32_t v;
    asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(a));
    return v;
}
__device__ __forceinline__ float bf16_at(uint32_t a) {   // a bf16 value, as a float
    unsigned short v;
    asm volatile("ld.shared.b16 %0, [%1];\n" : "=h"(v) : "r"(a));
    return __uint_as_float((uint32_t)v << 16);
}
__device__ __forceinline__ void sts_b32(uint32_t a, uint32_t v) {
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v));
}
__device__ __forceinline__ void sts_f32(uint32_t a, float v) {
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(a), "f"(v));
}
__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
    return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm4(uint32_t* r, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4t(uint32_t* r, const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
// mbarriers (shared::cta): init, arrive (release), arrive with an expected
// byte count, and a wait for the phase of a parity (acquire; .cluster where
// other blocks' writes complete on it)
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
    uint32_t done = 0;
    while (!done)
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}
// an arrive on bar once every cp.async this thread has issued so far has
// landed (the barrier's count includes it: .noinc)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait_cta(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done)
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}
// d += a b: a 16 x 16 (row), b 16 x 8 (col), d 16 x 8 f32.  With g = lane / 4
// and t = lane % 4, d[0], d[1] are row g, columns 2t, 2t + 1; d[2], d[3] row
// g + 8.
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// The tile block's schedule (K3's pass 1, K9's, K10).  The producer warp
// walks the block's tiles and, for each, the same products as the consumers,
// staging every product's weight chunks (KC rows of W^T or W, Prod) from
// wpad into a ring of ST stages with cp.async, each lane arriving on the
// stage's "full" mbarrier once its copies have landed (cp.async.mbarrier.
// arrive.noinc; bulk copies, a row each, measured slower).  It runs ahead of the
// consumers across products and tiles, as far as the ring allows: before it
// refills a stage it waits on the stage's "empty" mbarrier, on which every
// consumer warp of both groups arrives when it has read the chunk.  So the
// weights cross L2 once a tile, and the next product's and the next tile's
// first chunks are in flight while the groups run their epilogues.
//
// The consumers are NG = 2 warp groups; group g takes rows [g TG, + TG) of
// every tile, with a named barrier of its own (bar.sync 1 + g) where the
// block used to synchronise, so one group's epilogues, loss step and row
// stores can run while the other's products do.  Both groups start
// together: with group 1 half the ring behind group 0, K3 took 0.6 % (T1
// widths) and 4 % (434-wide critic) longer at 393,216 rows, NVIDIA H100
// 80GB HBM3, 700 W.

// Diagnostic builds only (-DK3_CLOCKS=1): lane 0 of every consumer warp
// adds the clock cycles of each phase of its tiles (K3_PHASES in
// prof_update.py: products, waits on a full stage, group barriers,
// epilogues, the loss step, scratch stores, the x0 rows), the producer's
// lane 0 its waits on an empty stage and its copies, to k3_clk[phase];
// bg_k3_clocks reads and clears them.  The default build has none of it.
#ifndef K3_CLOCKS
#define K3_CLOCKS 0
#endif
enum { C_MMA, C_FULL, C_BAR, C_EPI, C_LOSS, C_STORE, C_X0, C_EMPTY, C_ISSUE, K3_NCLK };
#if K3_CLOCKS
__device__ unsigned long long k3_clk[K3_NCLK];
#define K3_CLK(gp, k)                          \
    do {                                       \
        const long long now_ = clock64();      \
        (gp).clk[k] += now_ - (gp).t;          \
        (gp).t = now_;                         \
    } while (0)
#else
#define K3_CLK(gp, k)
#endif

// A warp's place in a tile block: its group (NG for the producer), its
// thread in the group, lane, warp in the group and the group's first row of
// a tile; the ring's next stage and the parity of that stage's phase
struct Grp {
    int g, gtid, lane, warp, r0;
    int stg = 0;
    uint32_t ph = 0;
#if K3_CLOCKS
    long long t = 0;
    unsigned long long clk[K3_NCLK] = {};
#endif
};
template <typename T> __device__ __forceinline__ Grp grp_of(int tid) {
    Grp gp;
    gp.g = tid / GT;
    gp.gtid = tid % GT;
    gp.lane = tid & 31;
    gp.warp = gp.gtid >> 5;
    gp.r0 = gp.g * Smem<T>::TG;
#if K3_CLOCKS
    gp.t = clock64();
#endif
    return gp;
}
__device__ __forceinline__ void group_bar(Grp& gp) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + gp.g), "n"(GT) : "memory");
    K3_CLK(gp, C_BAR);
}
// ring mbarriers: full[s], then empty[s]
template <typename T> __device__ __forceinline__ uint32_t full_bar(const Smem<T>& s, int st) {
    return smem_u32(s.bar + st);
}
template <typename T> __device__ __forceinline__ uint32_t empty_bar(const Smem<T>& s, int st) {
    return smem_u32(s.bar + CT<T>::ST + st);
}
// A warp's place in the ring while it walks a product, in registers (Grp
// keeps it between products): the stage and the parity of its phase
template <typename T> struct Cursor {
    static constexpr int ST = CT<T>::ST;
    uint32_t full0;   // full[0]; full[s] lies 8 s bytes on, empty[s] 8 (ST + s)
    int stg;
    uint32_t ph;
    __device__ __forceinline__ Cursor(const Smem<T>& s, const Grp& gp)
        : full0(full_bar(s, 0)), stg(gp.stg), ph(gp.ph) {}
    __device__ __forceinline__ uint32_t full() const { return full0 + 8 * stg; }
    __device__ __forceinline__ uint32_t empty() const { return full0 + 8 * (ST + stg); }
    __device__ __forceinline__ void next() {
        if (++stg == ST) {
            stg = 0;
            ph ^= 1;
        }
    }
    __device__ __forceinline__ void save(Grp& gp) const {
        gp.stg = stg;
        gp.ph = ph;
    }
};
// The ring's mbarriers: full counts the producer's 32 lanes (a cp.async
// arrive each), empty every consumer warp
template <typename T> __device__ __forceinline__ void ring_init(const Smem<T>& s) {
    if (threadIdx.x == 0) {
        for (int st = 0; st < CT<T>::ST; ++st) {
            mbar_init(full_bar(s, st), 32);
            mbar_init(empty_bar(s, st), NW);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
}
// The consumers' end: both groups are here (named barrier 3)
__device__ __forceinline__ void groups_end() {
    asm volatile("bar.sync 3, %0;\n" ::"n"(NG * GT) : "memory");
}
#if K3_CLOCKS
__device__ __forceinline__ void clocks_out(const Grp& gp) {
    if (gp.lane == 0)
        for (int k = 0; k < K3_NCLK; ++k)
            if (gp.clk[k]) atomicAdd(&k3_clk[k], gp.clk[k]);
}
#endif

// One product of a tile: layer L of Net forward (x W^T, FWD) or its input
// gradient (dz W); the producer stages its chunks and the consumers multiply
// them from this one description.  Either is A B with B the row-major [R][LD]
// matrix at wpad + M: the layer's padded W^T (FWD, [inp][outp], in wpad's
// second half) or W (!FWD, [outp][inp]); R reduction rows; CW = 32 J >= LD
// columns.
template <typename Net, int L, bool FWD_> struct Prod {
    static constexpr bool FWD = FWD_;
    static constexpr int J = FWD ? (Net::out(L) + 31) / 32 : Net::in(L) / 32;
    static constexpr int M = FWD ? NWPAD + Net::wp(L) : Net::wp(L);
    static constexpr int LD = FWD ? Net::outp(L) : Net::inp(L);
    static constexpr int R = FWD ? Net::inp(L) : Net::outp(L);
};

// The producer's part of a product P: for every chunk of KC reduction rows,
// wait for the stage to be empty, then copy the chunk's rows [k0, k0 + KC)
// of P's matrix (W^T for FWD, W for !FWD; rows past R are not copied) into
// [KC][CW + PAD], 16 bytes a cp.async, the lanes along the rows, and arrive
// on the stage's full mbarrier once this lane's copies have landed.
// Columns past the row's LD values are not written: the consumers read them
// only for outputs their epilogue skips.
template <typename T, typename P>
__device__ __forceinline__ void produce(const T* __restrict__ wpad, const Smem<T>& s, Grp& gp) {
    constexpr int KC = CT<T>::KC, VEC = CT<T>::VEC, CP = P::J * 32 + CT<T>::PAD;
    constexpr int WS = Smem<T>::n_ws, PR = P::LD / VEC;   // 16-byte pieces a row
    // lane l < RPI LPR copies pieces l % LPR, + LPR, ... of rows l / LPR, +
    // RPI, ...
    constexpr int LPR = PR < 32 ? PR : 32, RPI = 32 / LPR;
    constexpr int NCH = (P::R + KC - 1) / KC;
    static_assert(PR % LPR == 0 && KC % RPI == 0, "a chunk's pieces over the lanes");
    const T* M = wpad + P::M;
    T* const ws = s.ws;
    const int v0 = gp.lane % LPR, r0 = gp.lane / LPR;
    Cursor<T> cur(s, gp);
    for (int ch = 0; ch < NCH; ++ch) {
        mbar_wait_cta(cur.empty(), cur.ph ^ 1);
        K3_CLK(gp, C_EMPTY);
        const int k0 = ch * KC, rows = P::R - k0 < KC ? P::R - k0 : KC;
        T* const dst = ws + cur.stg * WS;
        const T* const src = M + (size_t)(k0 + r0) * P::LD + v0 * VEC;
        T* const to = dst + r0 * CP + v0 * VEC;
#pragma unroll
        for (int r = 0; r < KC; r += RPI)
            if (r0 < RPI && r0 + r < rows)
#pragma unroll
                for (int v = 0; v < PR; v += LPR)
                    cp_async16(to + r * CP + v * VEC, src + (size_t)r * P::LD + v * VEC, true);
        cp_async_arrive(cur.full());
        cur.next();
        K3_CLK(gp, C_ISSUE);
    }
    cur.save(gp);
}
// a net's forward (layers 0-3) and its input gradients (layers 3-1), in the
// consumers' order
template <typename T, typename Net>
__device__ __forceinline__ void produce_fwd(const T* __restrict__ wpad, const Smem<T>& s, Grp& gp) {
    produce<T, Prod<Net, 0, true>>(wpad, s, gp);
    produce<T, Prod<Net, 1, true>>(wpad, s, gp);
    produce<T, Prod<Net, 2, true>>(wpad, s, gp);
    produce<T, Prod<Net, 3, true>>(wpad, s, gp);
}
template <typename T, typename Net>
__device__ __forceinline__ void produce_bwd(const T* __restrict__ wpad, const Smem<T>& s, Grp& gp) {
    produce<T, Prod<Net, 3, false>>(wpad, s, gp);
    produce<T, Prod<Net, 2, false>>(wpad, s, gp);
    produce<T, Prod<Net, 1, false>>(wpad, s, gp);
}

// A consumer warp has read its chunk: it frees the stage (one arrive a
// warp) and moves on in the ring
template <typename T> __device__ __forceinline__ void release(Cursor<T>& cur, int lane) {
    __syncwarp();
    if (lane == 0) mbar_arrive(cur.empty());
    cur.next();
}

// For every sample n of the group's rows of the tile and every column c < CW
// = 32 J of product P:
//     epi.out(n, c, sum_{r < R} A[n * lda + r] * B[r][c], epi.in(n, c))
// with B staged by produce, from the ring; A is read only below R.  out sees
// columns past B's end (as garbage) and must skip them.  bf16 takes two
// neighbouring columns a call (in2, out2: one conversion and one store for
// both, through the shared-memory accessors: K3 with bf16 through in and
// out took 3.7 % (T1 widths) and 1.6 % (434-wide critic) longer at 393,216
// rows, NVIDIA H100 80GB HBM3, 700 W).  The epilogue reads every input
// first, then computes and writes: its loads would not pass the stores
// otherwise (both shared memory), and each value would wait for the one
// before.  The caller has made A's rows visible to the group (a group
// barrier).
// f32: FMAs, a warp takes TG / NWG samples, a lane every 32nd column.
// bf16: mma.sync m16n8k16; warp w owns MT row tiles of 16 and NW8 column
// tiles of 8, and its epilogue reads the accumulators where the mma left
// them.  Every value is the chain over ascending k that the tile's shape
// does not change.
template <typename T, typename P, typename Epi>
__device__ __forceinline__ void gemm_epi(const T* A, int lda, Grp& gp, const Smem<T>& s,
                                         const Epi& epi) {
    constexpr int TG = Smem<T>::TG, KC = CT<T>::KC, CW = P::J * 32, R = P::R;
    constexpr bool F32 = std::is_same<T, float>::value;
    constexpr int CP = CW + CT<T>::PAD;             // row stride of a staged chunk
    constexpr int WS = Smem<T>::n_ws;
    constexpr int NCH = (R + KC - 1) / KC;
    const int lane = gp.lane, warp = gp.warp;
    const T* const ws = s.ws;
    Cursor<T> cur(s, gp);
    if constexpr (F32) {
        constexpr int NS = TG / NWG;
        const int m0 = gp.r0 + warp * NS;
        float acc[NS][P::J];
#pragma unroll
        for (int i = 0; i < NS; ++i)
#pragma unroll
            for (int j = 0; j < P::J; ++j) acc[i][j] = 0.0f;
        for (int ch = 0; ch < NCH; ++ch) {
            K3_CLK(gp, C_MMA);
            mbar_wait_cta(cur.full(), cur.ph);
            K3_CLK(gp, C_FULL);
            const T* Ws = ws + cur.stg * WS;
            const int k0 = ch * KC;
#pragma unroll 4
            for (int rr = 0; rr < KC; ++rr) {
                float a[NS], b[P::J];
#pragma unroll
                for (int i = 0; i < NS; ++i) a[i] = A[(m0 + i) * lda + k0 + rr];
#pragma unroll
                for (int j = 0; j < P::J; ++j) b[j] = Ws[rr * CP + lane + 32 * j];
#pragma unroll
                for (int i = 0; i < NS; ++i)
#pragma unroll
                    for (int j = 0; j < P::J; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
            }
            release(cur, lane);
        }
        cur.save(gp);
        K3_CLK(gp, C_MMA);
        float v[NS][P::J];
#pragma unroll
        for (int j = 0; j < P::J; ++j)
#pragma unroll
            for (int i = 0; i < NS; ++i) v[i][j] = epi.in(m0 + i, lane + 32 * j);
#pragma unroll
        for (int j = 0; j < P::J; ++j)
#pragma unroll
            for (int i = 0; i < NS; ++i) epi.out(m0 + i, lane + 32 * j, acc[i][j], v[i][j]);
    } else {
        // NCG column groups of NW8 8-wide tiles, NRG row groups of MT 16-row
        // tiles: 32 columns a warp where the rows leave enough warps; warps
        // past NCG * NRG only wait and release
        constexpr int NW8 = (CW / 32) * (TG / 16) >= NWG ? 4 : 2;
        constexpr int NCG = CW / (8 * NW8);
        constexpr int NRG = (NWG / NCG) < TG / 16 ? NWG / NCG : TG / 16;
        constexpr int MT = (TG / 16) / NRG;
        static_assert(NCG * NRG <= NWG && MT * NRG * 16 == TG, "warp tiling");
        const bool works = warp < NCG * NRG;
        const int m0 = gp.r0 + (warp / NCG) * MT * 16, n0 = (warp % NCG) * NW8 * 8;
        float acc[MT][NW8][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NW8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
        // this lane's row and column within the 8 x 8 matrices of an ldmatrix
        const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 8;
        for (int ch = 0; ch < NCH; ++ch) {
            K3_CLK(gp, C_MMA);
            mbar_wait_cta(cur.full(), cur.ph);
            K3_CLK(gp, C_FULL);
            if (works) {
                const T* Ws = ws + cur.stg * WS;
                const int k0 = ch * KC;
#pragma unroll
                for (int kk = 0; kk < KC; kk += 16) {
                    if (k0 + kk >= R) break;
                    uint32_t a[MT][4];
#pragma unroll
                    for (int i = 0; i < MT; ++i)
                        ldsm4(a[i], A + (m0 + 16 * i + lr) * lda + k0 + kk + lc);
#pragma unroll
                    for (int jp = 0; jp < NW8 / 2; ++jp) {
                        uint32_t b[4];
                        ldsm4t(b, Ws + (kk + lr) * CP + n0 + 16 * jp + lc);
#pragma unroll
                        for (int i = 0; i < MT; ++i) {
                            mma16816(acc[i][2 * jp], a[i], b[0], b[1]);
                            mma16816(acc[i][2 * jp + 1], a[i], b[2], b[3]);
                        }
                    }
                }
            }
            release(cur, lane);
        }
        cur.save(gp);
        K3_CLK(gp, C_MMA);
        if (works) {
            // acc[i][j][2 h], [2 h + 1]: row g + 8 h, columns 2 t and 2 t + 1
            const int g = lane >> 2, t = lane & 3;
            float2 v[MT][NW8][2];
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
                for (int j = 0; j < NW8; ++j)
#pragma unroll
                    for (int h = 0; h < 2; ++h)
                        v[i][j][h] = epi.in2(m0 + 16 * i + g + 8 * h, n0 + 8 * j + 2 * t);
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
                for (int j = 0; j < NW8; ++j)
#pragma unroll
                    for (int h = 0; h < 2; ++h)
                        epi.out2(m0 + 16 * i + g + 8 * h, n0 + 8 * j + 2 * t,
                                 make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]), v[i][j][h]);
        }
    }
    K3_CLK(gp, C_EPI);
}

// The group's rows [row0 + r0, + TG) of the tile buffer S (stride lds) into
// G [n][W], rows past n left out, after a group barrier (which also makes
// the rows visible to the group's next product): the group's threads copy
// 16 bytes each at a time, the rows being contiguous in G, and store them
// marked to leave L2 first (st.global.cs: left to L2's own policy, the 0.47
// GB of scratch rows at 98,304 rows that stream through it cost pass 1
// another 0.38 ms, NVIDIA H100 80GB HBM3, 700 W).  Each value is in the
// thread's registers before the store, so the rows may be written again
// once every thread of the group is past a later barrier.  S is read by a
// plain load (ld.shared by address: K3 took 1.8 % (T1 widths) and 4.4 %
// (434-wide critic) longer at 393,216 rows, NVIDIA H100 80GB HBM3, 700 W).
template <typename T, int W>
__device__ __forceinline__ void store_rows(const T* S, int lds, T* __restrict__ G, long row0, int n,
                                           Grp& gp) {
    constexpr int TG = Smem<T>::TG, VEC = CT<T>::VEC, units = W / VEC;
    group_bar(gp);
    const long first = row0 + gp.r0;
    const int rows = n - first < TG ? (int)(n - first) : TG;
    T* const g = G + first * W;
    const T* const sr = S + gp.r0 * lds;
    for (int u = gp.gtid; u < rows * units; u += GT) {
        const int r = u / units, c = (u % units) * VEC;
        __stcs(reinterpret_cast<int4*>(g + r * W + c), *reinterpret_cast<const int4*>(sr + r * lds + c));
    }
    K3_CLK(gp, C_STORE);
}
// After a hidden layer: its x rows to the scratch (K3's pass 1), or (K10,
// scr null) only the barrier before the next product reads them
template <typename T, int W>
__device__ __forceinline__ void rows_out(const T* S, int lds, T* scr, int off, long row0, int n,
                                         Grp& gp) {
    if (scr) store_rows<T, W>(S, lds, scr + (size_t)off * n, row0, n, gp);
    else group_bar(gp);
}

// A layer's epilogue: z = round_T(round_T(acc) + b) in T; a hidden layer
// writes ELU(z) and, for its input gradient, ELU'(z) = round_T(z > 0 ? 1 :
// exp(z)) (both T) from the one exp(z), the last writes z as f32 to
// outf[n * ldo + o].  exp(z) is formed whatever the sign: written as a
// conditional, nvcc branches around it per value, and the branches run one
// after another.
template <typename T, int OUT, bool LAST> struct FwdEpi {
    const T* b;
    T *Z, *Xn;
    float* outf;
    int ldz, ldn, ldo;
    uint32_t bs, zs, xs, fs;   // b, Z, Xn, outf as shared addresses (out2)
    __device__ __forceinline__ FwdEpi(const T* b_, T* Z_, T* Xn_, float* outf_, int ldz_, int ldn_,
                                      int ldo_)
        : b(b_), Z(Z_), Xn(Xn_), outf(outf_), ldz(ldz_), ldn(ldn_), ldo(ldo_), bs(smem_u32(b_)),
          zs(smem_u32(Z_)), xs(smem_u32(Xn_)), fs(smem_u32(outf_)) {}
    __device__ __forceinline__ float in(int, int o) const {
        return !LAST || o < OUT ? CT<T>::to_f(b[o]) : 0.0f;
    }
    __device__ __forceinline__ void out(int n, int o, float acc, float bo) const {
        if (LAST && o >= OUT) return;
        const float z = rnd<T>(rnd<T>(acc) + bo);
        if (LAST) {
            outf[n * ldo + o] = z;
        } else {
            const float e = expf(z);
            Z[n * ldz + o] = CT<T>::from_f(z > 0.0f ? 1.0f : e);
            Xn[n * ldn + o] = CT<T>::from_f(z > 0.0f ? z : e - 1.0f);
        }
    }
    // bf16, columns o and o + 1 (o even; a hidden layer's width is a multiple
    // of 32): out's values, one conversion and one store for both
    __device__ __forceinline__ float2 in2(int, int o) const {
        return make_float2(!LAST || o < OUT ? bf16_at(bs + 2 * o) : 0.0f,
                           !LAST || o + 1 < OUT ? bf16_at(bs + 2 * o + 2) : 0.0f);
    }
    __device__ __forceinline__ void out2(int n, int o, float2 acc, float2 bo) const {
        if (LAST && o >= OUT) return;
        const float2 r = __bfloat1622float2(__floats2bfloat162_rn(acc.x, acc.y));
        const __nv_bfloat162 zh = __floats2bfloat162_rn(r.x + bo.x, r.y + bo.y);
        const float2 z = __bfloat1622float2(zh);
        if (LAST) {
            sts_f32(fs + 4 * (n * ldo + o), z.x);
            if (o + 1 < OUT) sts_f32(fs + 4 * (n * ldo + o + 1), z.y);
        } else {
            const float ex = expf(z.x), ey = expf(z.y);
            sts_b32(zs + 2 * (n * ldz + o),
                    bf2_bits(__floats2bfloat162_rn(z.x > 0.0f ? 1.0f : ex, z.y > 0.0f ? 1.0f : ey)));
            sts_b32(xs + 2 * (n * ldn + o), bf2_bits(__floats2bfloat162_rn(
                                                z.x > 0.0f ? z.x : ex - 1.0f, z.y > 0.0f ? z.y : ey - 1.0f)));
        }
    }
};

// One dense layer L of Net (FwdEpi)
template <typename T, typename Net, int L>
__device__ __forceinline__ void layer_fwd(const Smem<T>& s, Grp& gp, const T* X, int ldx, T* Z,
                                          int ldz, T* Xn, int ldn, float* outf, int ldo) {
    const FwdEpi<T, Net::out(L), L == 3> epi(s.bias + bias_off<Net>(L), Z, Xn, outf, ldz, ldn, ldo);
    gemm_epi<T, Prod<Net, L, true>>(X, ldx, gp, s, epi);
}

// The forward of one net on the group's rows of the tile in s.x0; with a
// scratch (K3's pass 1) each hidden layer's output x_l (the next layer's
// input) also goes to its rows there.  The last layer's outputs are the
// group's after a group barrier.  (Not inlined, like net_bwd: each then
// gets registers of its own, and the one giant function they would make
// spills.)
template <typename T, typename Net>
__device__ __noinline__ void net_fwd(const Smem<T>& s, Grp& gp, float* outf, T* scr, long row0,
                                     int n) {
    using S = Smem<T>;
    layer_fwd<T, Net, 0>(s, gp, s.x0, S::L0, s.z1, S::LZ1, s.xa, S::LA, nullptr, 0);
    rows_out<T, Net::H1>(s.xa, S::LA, scr, scr_x<Net>(1), row0, n, gp);
    layer_fwd<T, Net, 1>(s, gp, s.xa, S::LA, s.z2, S::LZ2, s.xb, S::LB, nullptr, 0);
    rows_out<T, Net::H2>(s.xb, S::LB, scr, scr_x<Net>(2), row0, n, gp);
    layer_fwd<T, Net, 2>(s, gp, s.xb, S::LB, s.z3, S::LZ3, s.xa, S::LA, nullptr, 0);
    rows_out<T, Net::H3>(s.xa, S::LA, scr, scr_x<Net>(3), row0, n, gp);
    layer_fwd<T, Net, 3>(s, gp, s.xa, S::LA, nullptr, 0, nullptr, 0, outf, Net::DO);
    group_bar(gp);
}

// An input gradient's epilogue: dz_prev = round_T(round_T(acc) * g) with g
// = ELU'(z_prev) as the forward's epilogue left it, written over it
template <typename T> struct BwdEpi {
    T* Zp;
    int ldp;
    uint32_t zs;   // Zp as a shared address (in2, out2)
    __device__ __forceinline__ BwdEpi(T* Zp_, int ldp_) : Zp(Zp_), ldp(ldp_), zs(smem_u32(Zp_)) {}
    __device__ __forceinline__ float in(int n, int k) const { return CT<T>::to_f(Zp[n * ldp + k]); }
    __device__ __forceinline__ void out(int n, int k, float acc, float g) const {
        Zp[n * ldp + k] = CT<T>::from_f(rnd<T>(acc) * g);
    }
    // bf16, columns k and k + 1 (k even): out's values, one load, conversion
    // and store for both
    __device__ __forceinline__ float2 in2(int n, int k) const {
        const uint32_t v = lds_b32(zs + 2 * (n * ldp + k));
        return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
    }
    __device__ __forceinline__ void out2(int n, int k, float2 acc, float2 g) const {
        const float2 dh = __bfloat1622float2(__floats2bfloat162_rn(acc.x, acc.y));
        sts_b32(zs + 2 * (n * ldp + k), bf2_bits(__floats2bfloat162_rn(dh.x * g.x, dh.y * g.y)));
    }
};

// The input gradient of layer L of Net (BwdEpi)
template <typename T, typename Net, int L>
__device__ __forceinline__ void layer_bwd_input(const Smem<T>& s, Grp& gp, const T* DZ, int ldd,
                                                T* Zp, int ldp) {
    gemm_epi<T, Prod<Net, L, false>>(DZ, ldd, gp, s, BwdEpi<T>(Zp, ldp));
}

// The input gradients of one net from the last layer's dz in s.dzl; every
// layer's dz goes to its scratch rows, for pass 2's weight gradients.
template <typename T, typename Net>
__device__ __noinline__ void net_bwd(const Smem<T>& s, Grp& gp, T* scr, long row0, int n) {
    using S = Smem<T>;
    store_rows<T, DZ3W>(s.dzl, S::LD, scr + (size_t)scr_dz<Net>(3) * n, row0, n, gp);
    layer_bwd_input<T, Net, 3>(s, gp, s.dzl, S::LD, s.z3, S::LZ3);
    store_rows<T, Net::H3>(s.z3, S::LZ3, scr + (size_t)scr_dz<Net>(2) * n, row0, n, gp);
    layer_bwd_input<T, Net, 2>(s, gp, s.z3, S::LZ3, s.z2, S::LZ2);
    store_rows<T, Net::H2>(s.z2, S::LZ2, scr + (size_t)scr_dz<Net>(1) * n, row0, n, gp);
    layer_bwd_input<T, Net, 1>(s, gp, s.z2, S::LZ2, s.z1, S::LZ1);
    store_rows<T, Net::H1>(s.z1, S::LZ1, scr + (size_t)scr_dz<Net>(0) * n, row0, n, gp);
}

// the group's rows of rows [tile * TN, tile * TN + TN) of obsc into s.x0,
// zero past n_rows and past NCRIT
template <typename T>
__device__ __forceinline__ void load_x0(const Smem<T>& s, const T* __restrict__ obsc, int tile,
                                        int n_rows, Grp& gp) {
    // the loads of 8 values a thread first, then their stores: each load's
    // latency once a batch
    constexpr int TN = CT<T>::TN, TG = Smem<T>::TG, NV = (TG * X0W + GT - 1) / GT, NB = 8;
#pragma unroll
    for (int j0 = 0; j0 < NV; j0 += NB) {
        T v[NB];
#pragma unroll
        for (int j = 0; j < NB; ++j) {
            const int idx = gp.gtid + (j0 + j) * GT, n = gp.r0 + idx / X0W, c = idx % X0W;
            const long row = (long)tile * TN + n;
            v[j] = CT<T>::from_f(0.0f);
            if (idx < TG * X0W && row < n_rows && c < NCRIT) v[j] = obsc[row * NCRIT + c];
        }
#pragma unroll
        for (int j = 0; j < NB; ++j) {
            const int idx = gp.gtid + (j0 + j) * GT;
            if (idx < TG * X0W) s.x0[(gp.r0 + idx / X0W) * Smem<T>::L0 + idx % X0W] = v[j];
        }
    }
    K3_CLK(gp, C_X0);
}

// logstd (f32, from p) and exp(2 logstd) into shared memory
template <typename T>
__device__ __forceinline__ void load_logstd(const Smem<T>& s, const float* __restrict__ p,
                                            int off) {
    if (threadIdx.x < NACT) {
        const float ls = p[off + threadIdx.x];
        s.logstd[threadIdx.x] = ls;
        s.var[threadIdx.x] = expf(2.0f * ls);
    }
}

// every layer's bias from staged into s.bias
template <typename T, typename Net>
__device__ __forceinline__ void load_bias(const Smem<T>& s, const T* __restrict__ staged,
                                          const int* ob) {
    for (int l = 0; l < 4; ++l)
        for (int o = threadIdx.x; o < Net::out(l); o += NT)
            s.bias[bias_off<Net>(l) + o] = staged[ob[l] + o];
}

// Row r's log-prob of its action act[0 .. NACT) under N(s.mu row, exp(logstd));
// fills mu and diff = act - mu.  K3 and K10 both go through this.
template <typename T>
__device__ __forceinline__ float row_logp(const Smem<T>& s, int r, const float* __restrict__ act,
                                          float* mu, float* diff) {
    float logp = 0.0f;
#pragma unroll
    for (int k = 0; k < NACT; ++k) {
        mu[k] = s.mu[r * NACT + k];
        diff[k] = act[k] - mu[k];
        logp += -0.5f * diff[k] * diff[k] / s.var[k] - s.logstd[k] - 0.5f * LOG2PI;
    }
    return logp;
}
// ---------------------------------------------------------------------------
// Every launch's first kernel: the weights of `staged` into the zero-padded
// layer layout of wpad (NWPAD values), and for a tile block's launch (n =
// 2 NWPAD) each layer transposed after them, [rup16(in)][rup16(out)] at
// NWPAD + its offset: the rows that its forward's chunks stage.
template <typename T, typename Net>
__device__ __forceinline__ void pad_net(int i, bool tr, const T* __restrict__ staged,
                                        const int* oW, T* __restrict__ wpad) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
        const int w0 = Net::wp(l), inp = Net::inp(l), outp = Net::outp(l);
        if (i >= w0 && i < w0 + outp * inp) {
            const int o = tr ? (i - w0) % outp : (i - w0) / inp;
            const int k = tr ? (i - w0) / outp : (i - w0) % inp;
            wpad[i] = (o < Net::out(l) && k < Net::in(l)) ? staged[oW[l] + o * Net::in(l) + k]
                                                          : CT<T>::from_f(0.0f);
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(K4_NT) k_pad(const T* __restrict__ staged, Offs offs,
                                              T* __restrict__ wpad, int n) {
    const int i = blockIdx.x * K4_NT + threadIdx.x;
    if (i >= n) return;
    const bool tr = i >= NWPAD;
    const int j = tr ? i - NWPAD : i;
    T* const w = tr ? wpad + NWPAD : wpad;
    if (j < ActorNet::end) pad_net<T, ActorNet>(j, tr, staged, offs.aW, w);
    else pad_net<T, CriticNet>(j, tr, staged, offs.cW, w);
}

// ---------------------------------------------------------------------------
// K2 and K8: the critic forward on its own, with K2's GAE walk fused in
// (k2_critic, one launch after the weight copy).
// The critic's weights stay in shared memory for the whole launch: a
// cluster of CL blocks (bf16 2, f32 4) splits every hidden layer's output
// columns, and each block holds its share of the padded weights (124 KB in
// bf16, 113 KB in f32 at the T1 widths), loaded once: ~16 MB from L2 per
// call, where a tile block restaged all 0.23 MB per 64 rows (~0.37 GB).  A
// tile is TN consecutive rows (bf16 64, f32 32).  Where that shape does not
// fit a block (T1Standup's 434-wide input: 222 KB of bf16 weights a
// block), CritPick takes clusters of twice the blocks and tiles of half
// the rows (bf16 4 and 32: 113 KB of weights; f32 8 and 16); a layer's
// share narrower than a warp's tile then leaves warps or lanes idle, and
// the last layer's warp keeps its block's rows of a 16-row tile. each of a block's two warp groups
// takes half of every tile with buffers, mbarriers and block-level barriers
// of its own, so one group's products run while the other waits for its
// partners' outputs.  A group's two activation buffers ping-pong and hold
// ELU outputs only.  After a layer the group sends its columns to the same
// group of the other blocks by st.async, 16 bytes each, which complete bytes
// on that group's mbarrier; a group reads a layer's outputs after its
// barrier and its mbarrier's phase.  No cluster barrier runs in the loop
// (one costs ~1,200 cycles: NVIDIA H100 80GB HBM3, 700 W, prof_update
// --variant).  Every value is the same mma.sync (f32: fmaf) chain in
// ascending k as gemm_epi<FWD> gives it, with the same epilogue, so K2 and
// K8 equal K3's and K9's values bitwise.
//
// K2 (GAE): a cluster owns a group of TN envs over all T + 1 planes (tile
// (g, t) is rows t B + g TN ...), keeps the values of its block's EW = TN /
// CL envs in shared memory, the first max_planes planes of them (past that,
// at horizons that shared memory does not hold, the rest go to the block's
// rows of a global spill, written and read back by the same warp), and
// walks them backwards at the group's end, a thread per env, in the
// reference's arithmetic; each warp group of each
// block writes its partial of sum(adv) and sum(adv^2), and the last block
// to arrive (an integer counter, reset to 0 by that block) adds the
// partials in order.  K8: a cluster walks tiles of rows [0, n_rows); each
// block writes the values of its rows of a tile.
//
// What bounds it: each warp's products (mma.sync fed by ldmatrix from
// shared memory) and epilogues (ELU's expf for every value), and the waits
// for the partner blocks' outputs; see PERF.md.

// Diagnostic builds only (-DK2_CLOCKS=1): lane 0 of every warp of k2_critic
// adds the clock cycles of each phase of a tile to k2_clk[phase];
// bg_k2_clocks reads and clears them.  The default build has none of it.
#ifndef K2_CLOCKS
#define K2_CLOCKS 0
#endif
#if K2_CLOCKS
#define K2_NCLK 8
__device__ unsigned long long k2_clk[K2_NCLK];
#define K2_CLK(k)                                                        \
    do {                                                                 \
        const long long now_ = clock64();                                \
        if ((threadIdx.x & 31) == 0) atomicAdd(&k2_clk[k], now_ - t_clk); \
        t_clk = now_;                                                    \
    } while (0)
#define K2_CLK_START long long t_clk = clock64()
#else
#define K2_CLK(k)
#define K2_CLK_START
#endif
// The critic kernel's shape at CL_ blocks a cluster and TN_ rows a tile;
// Crit<T> picks it (below)
template <typename T, int CL_, int TN_> struct CritAt {
    static constexpr bool F32 = std::is_same<T, float>::value;
    static constexpr int CL = CL_;                  // blocks in a cluster
    static constexpr int TN = TN_;                  // rows in a tile (a cluster's unit)
    static constexpr int EW = TN / CL;              // rows (envs) a block keeps values of
    static constexpr int NTH = 256;                 // threads of a block (16 warps: slower)
    static constexpr int NWP = NTH / 32;
    // a block's two warp groups each take half of every tile, with buffers,
    // mbarriers and block-level barriers of their own
    static constexpr int NG = 2, TG = TN / NG, EG = TG / CL, GT = NTH / NG, NWG = NWP / NG;
    static constexpr int V16 = 16 / (int)sizeof(T); // values in 16 bytes
    // row strides: weights [out][in + PW] (bf16: an odd number of 16-byte
    // units, so ldmatrix is conflict-free; f32: in + 1, so 32 lanes reading
    // 32 rows hit 32 banks); activations [TN][HB + PAD]
    static constexpr int PW = F32 ? 1 : 8;
    static constexpr int HB = cmax(cmax(CH1, CH2), CH3);
    static constexpr int LA = HB + CT<T>::PAD, LX = X0W + CT<T>::PAD;
    static constexpr HD int outs(int l) { return CriticNet::out(l) / CL; }   // l < 3
    static constexpr HD int lw(int l) { return CriticNet::inp(l) + PW; }
    static constexpr int W4R = F32 ? 1 : 16;        // rows of the last layer kept
    static constexpr HD int al(int n) { return rup(n, V16); }
    static constexpr HD int wo(int l) {             // offset of layer l's share
        return l == 0 ? 0 : wo(l - 1) + al(outs(l - 1) * lw(l - 1));
    }
    static constexpr int NWV = wo(3) + al(W4R * lw(3));
    static constexpr int NBC = CH1 + CH2 + CH3 + 1;
    // group g's buffers at XA + g GREG: its xa, xb [TG][LA], then x0 [TG][LX]
    static constexpr int GREG = 2 * TG * LA + TG * LX;
    static constexpr int XA = NWV, BIAS = XA + NG * GREG;
    static constexpr int MBAR = BIAS + al(NBC);              // two mbarriers a group
    static constexpr int NTV = MBAR + 16 * NG / (int)sizeof(T);
    // bytes a group receives from the other blocks for layer l's outputs
    static constexpr HD int rx_bytes(int l) { return (CL - 1) * TG * outs(l) * (int)sizeof(T); }
    static constexpr size_t fixed = (size_t)NTV * sizeof(T);   // bytes; then the values
    static HD size_t bytes(int planes) { return fixed + (size_t)planes * EW * sizeof(float); }
    static constexpr int max_planes =
        fixed <= SMEM_MAX ? (int)((SMEM_MAX - fixed) / (EW * sizeof(float))) : 0;
};
// The shape of a build: clusters of 2 blocks and 64-row tiles in bf16 (4
// and 32 in f32), the T1 networks' shape, where a block holds its share of
// the weights and the buffers with room for two planes of values; past that
// (a wide critic input: 434 columns) clusters of 4 and 32-row tiles in bf16
// (8 and 16 in f32), each block a quarter (an eighth) of the weights and
// half the rows.
template <typename T> struct CritPick {
    static constexpr bool F32 = std::is_same<T, float>::value;
    using Base = CritAt<T, F32 ? 4 : 2, F32 ? 32 : 64>;
    using Split = CritAt<T, F32 ? 8 : 4, F32 ? 16 : 32>;
    using type = typename std::conditional<(Base::max_planes >= 2), Base, Split>::type;
};
template <typename T> using Crit = typename CritPick<T>::type;
static_assert(CH1 % (Crit<float>::CL * 16) == 0 && CH2 % (Crit<float>::CL * 16) == 0
              && CH3 % (Crit<float>::CL * 16) == 0
              && CH1 % (Crit<__nv_bfloat16>::CL * 16) == 0
              && CH2 % (Crit<__nv_bfloat16>::CL * 16) == 0
              && CH3 % (Crit<__nv_bfloat16>::CL * 16) == 0,
              "critic widths: a block's share of each layer a multiple of 16 columns");
static_assert(Crit<float>::max_planes >= 2 && Crit<__nv_bfloat16>::max_planes >= 2,
              "the critic's shared memory leaves room for the values of T = 1");
static_assert(Crit<float>::TG * X0W % Crit<float>::GT == 0
              && Crit<__nv_bfloat16>::TG * X0W % Crit<__nv_bfloat16>::GT == 0,
              "a group's x0 tile in whole registers a thread");

__device__ __forceinline__ uint32_t mapa(uint32_t a, int r) {
    uint32_t o;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(o) : "r"(a), "r"(r));
    return o;
}
__device__ __forceinline__ void st_async(uint32_t addr, uint32_t v, uint32_t bar) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
                 ::"r"(addr), "r"(v), "r"(bar) : "memory");
}
// A warp group's columns [rank outs, + outs) of rows [0, TG) of a layer's
// outputs at gx + off to the other blocks' same group (rx[r]: that group's
// buffers in block r as a cluster address), 16 bytes a st.async, each
// completing its bytes on the group's mbarrier rb[r] in block r.  (A 4-byte
// st.async per value pair as the epilogue forms it took 4% longer; each
// warp sending its own rows as soon as it has written them, no faster.)
template <typename T>
__device__ __forceinline__ void share_slice(const T* gx, int off, int outs, int rank,
                                            const uint32_t* rx, const uint32_t* rb, int gtid) {
    using C = Crit<T>;
    const int nv = outs / C::V16, cb = rank * outs;
    for (int c = gtid; c < C::TG * nv; c += C::GT) {
        const int e = off + (c / nv) * C::LA + cb + (c % nv) * C::V16;
        const uint4 v = *reinterpret_cast<const uint4*>(gx + e);
#pragma unroll
        for (int r = 0; r < C::CL; ++r)
            if (r != rank)
                asm volatile(
                    "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, "
                    "%3, %4}, [%5];\n" ::"r"(rx[r] + (uint32_t)(e * sizeof(T))),
                    "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(rb[r]) : "memory");
    }
}

struct K2Args {
    const float *rew, *nonterm, *timeout;
    float *adv, *ret, *values, *part, *sums;
    float* spill;    // K2: [blocks][T + 1 - splanes][EW] f32, null if splanes = T + 1
    unsigned* count;
    int n_rows, T, B;
    int splanes;     // K2: the planes of values kept in shared memory
    float gamma, lam;
};

// One hidden layer's share of the block: columns [rank OUTS, + OUTS) of
// round_T(x W^T) + b, ELU, written to those columns of the destination in
// every block of the cluster (put)
template <typename T, int L>
__device__ __forceinline__ void crit_layer(const T* X, int ldx, const T* Ws, const T* bias,
                                           T* out, int rank, int gtid) {
    using C = Crit<T>;
    constexpr int OUTS = C::outs(L), R = CriticNet::inp(L), NWP = C::NWG;
    const int lane = gtid & 31, warp = gtid >> 5;
    const int cb = rank * OUTS;
    // the layer's epilogue on one value and its (f32) bias
    auto act = [](float acc, float b) {
        // layer_fwd's ELU, with exp(z) - 1 formed whatever the sign: written
        // as a conditional, nvcc branches around it per value, and the
        // branches' dependency chains then run one after another
        const float z = rnd<T>(rnd<T>(acc) + b);
        const float em1 = expf(z) - 1.0f;
        return z > 0.0f ? z : em1;
    };
    bias += CriticNet::hsum(L) + cb;
    if constexpr (C::F32) {
        // a lane every 32nd column; a share narrower than 32 columns (16 at
        // clusters of 8) leaves the lanes past it idle
        constexpr int NS = C::TG / NWP, J = (OUTS + 31) / 32;
        constexpr bool FULL_J = OUTS % 32 == 0;
        static_assert(NS * NWP == C::TG, "a warp's rows");
        float acc[NS][J];
#pragma unroll
        for (int i = 0; i < NS; ++i)
#pragma unroll
            for (int j = 0; j < J; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
        for (int k = 0; k < R; ++k) {
            float a[NS], b[J];
#pragma unroll
            for (int i = 0; i < NS; ++i) a[i] = X[(warp * NS + i) * ldx + k];
#pragma unroll
            for (int j = 0; j < J; ++j)
                b[j] = (FULL_J || lane + 32 * j < OUTS) ? Ws[(lane + 32 * j) * C::lw(L) + k] : 0.0f;
#pragma unroll
            for (int i = 0; i < NS; ++i)
#pragma unroll
                for (int j = 0; j < J; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        // every value first, then the stores (which the compiler may not
        // move past the bias loads: both are shared memory)
        float bj[J];
#pragma unroll
        for (int j = 0; j < J; ++j)
            bj[j] = (FULL_J || lane + 32 * j < OUTS) ? CT<T>::to_f(bias[lane + 32 * j]) : 0.0f;
#pragma unroll
        for (int i = 0; i < NS; ++i)
#pragma unroll
            for (int j = 0; j < J; ++j) acc[i][j] = act(acc[i][j], bj[j]);
#pragma unroll
        for (int i = 0; i < NS; ++i)
#pragma unroll
            for (int j = 0; j < J; ++j)
                if (FULL_J || lane + 32 * j < OUTS)
                    out[(warp * NS + i) * C::LA + cb + lane + 32 * j] = acc[i][j];
    } else {
        // NCG column groups of NW8 8-wide tiles, NRG row groups of MT 16-row
        // tiles: 32 columns a warp where the rows leave enough warps; warps
        // past NCG * NRG have no tile (a 32-column share of 16 rows: 2 of 4)
        constexpr int NW8 = (OUTS / 32) * (C::TG / 16) >= NWP ? 4 : 2;
        constexpr int NCG = OUTS / (8 * NW8);
        constexpr int NRG = cmax(1, NWP / NCG) < C::TG / 16 ? cmax(1, NWP / NCG) : C::TG / 16;
        constexpr int MT = (C::TG / 16) / NRG;
        static_assert(NCG * NRG <= NWP && MT * NRG * 16 == C::TG, "warp tiling");
        if constexpr (NCG * NRG < NWP) {
            if (warp >= NCG * NRG) return;
        }
        const int m0 = (warp / NCG) * MT * 16, n0 = (warp % NCG) * 8 * NW8;
        float acc[MT][NW8][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NW8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
        const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 8;   // A
        const int fr = (lane & 7) + (lane >> 4) * 8, fc = ((lane >> 3) & 1) * 8;   // B
#pragma unroll 2
        for (int kk = 0; kk < R; kk += 16) {
            uint32_t a[MT][4];
#pragma unroll
            for (int i = 0; i < MT; ++i) ldsm4(a[i], X + (m0 + 16 * i + lr) * ldx + kk + lc);
#pragma unroll
            for (int jp = 0; jp < NW8 / 2; ++jp) {
                uint32_t b[4];
                ldsm4(b, Ws + (n0 + 16 * jp + fr) * C::lw(L) + kk + fc);
#pragma unroll
                for (int i = 0; i < MT; ++i) {
                    mma16816(acc[i][2 * jp], a[i], b[0], b[1]);
                    mma16816(acc[i][2 * jp + 1], a[i], b[2], b[3]);
                }
            }
        }
        // every value first, then the stores (which the compiler may not
        // move past the bias loads: both are shared memory)
        const int g = lane >> 2, t = lane & 3;
        float bj[NW8][2];
#pragma unroll
        for (int j = 0; j < NW8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) bj[j][e] = CT<T>::to_f(bias[n0 + 8 * j + 2 * t + e]);
        __nv_bfloat162 x[MT][NW8][2];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NW8; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    x[i][j][h].x = CT<T>::from_f(act(acc[i][j][2 * h], bj[j][0]));
                    x[i][j][h].y = CT<T>::from_f(act(acc[i][j][2 * h + 1], bj[j][1]));
                }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NW8; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int n = m0 + 16 * i + g + 8 * h, o = n0 + 8 * j + 2 * t;
                    *reinterpret_cast<__nv_bfloat162*>(out + n * C::LA + cb + o) = x[i][j][h];
                }
    }
}

// The last layer (one output) on the group's EG rows [rank EG, + EG) of its
// tile X: out(e, value) for each row e of them
template <typename T, typename Out>
__device__ __forceinline__ void crit_value(const T* X, const T* W4, const T* bias, int rank,
                                           int gtid, Out out) {
    using C = Crit<T>;
    constexpr int R = CriticNet::inp(3);
    const float b4 = CT<T>::to_f(bias[CriticNet::hsum(3)]);
    const int tid = gtid, lane = tid & 31, warp = tid >> 5;
    if constexpr (C::F32) {
        if (tid < C::EG) {
            const T* x = X + (rank * C::EG + tid) * C::LA;
            float acc = 0.0f;
#pragma unroll 8
            for (int k = 0; k < R; ++k) acc = fmaf(x[k], W4[k], acc);
            out(tid, rnd<T>(rnd<T>(acc) + b4));
        }
    } else {
        // warps, a 16-row tile each; a block's rows fewer than 16 (4 at
        // clusters of 4) take the 16-row tile that holds them and keep
        // their own rows of it
        constexpr int MW = (C::EG + 15) / 16;
        static_assert(C::TG % 16 == 0 && MW <= C::NWG, "last-layer warps");
        if (warp < MW) {
            const int lo = rank * C::EG + 16 * warp;   // the warp's first own row
            const int m = (C::EG % 16 == 0 || lo + 16 <= C::TG) ? lo : C::TG - 16;
            const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 8;
            const int fr = (lane & 7) + (lane >> 4) * 8, fc = ((lane >> 3) & 1) * 8;
            float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int kk = 0; kk < R; kk += 16) {
                uint32_t a[4], b[4];
                ldsm4(a, X + (m + lr) * C::LA + kk + lc);
                ldsm4(b, W4 + fr * C::lw(3) + kk + fc);
                mma16816(acc, a, b[0], b[1]);
            }
            if ((lane & 3) == 0) {   // column 0: rows g and g + 8
                const int g = lane >> 2;
                if constexpr (C::EG % 16 == 0) {
                    out(16 * warp + g, rnd<T>(rnd<T>(acc[0]) + b4));
                    out(16 * warp + g + 8, rnd<T>(rnd<T>(acc[2]) + b4));
                } else {
                    const int hi = rank * C::EG + C::EG;
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int r = m + g + 8 * h;
                        if (r >= lo && r < hi) out(r - rank * C::EG, rnd<T>(rnd<T>(acc[2 * h]) + b4));
                    }
                }
            }
        }
    }
}

// A group's rows [row0, row0 + TG) of obsc (those r < nvalid) into
// registers, zero elsewhere and past NCRIT; store puts them in its x0 tile
template <typename T> struct X0Regs {
    static constexpr int N = Crit<T>::TG * X0W / Crit<T>::GT;
    T v[N];
    // volatile loads: issued here, not moved down to their first use
    __device__ __forceinline__ void load(const T* __restrict__ obsc, long row0, int nvalid,
                                         int gtid) {
#pragma unroll
        for (int j = 0; j < N; ++j) {
            const int idx = gtid + j * Crit<T>::GT, n = idx / X0W, c = idx % X0W;
            v[j] = CT<T>::from_f(0.0f);
            if (n < nvalid && c < NCRIT) {
                const T* src = obsc + (row0 + n) * NCRIT + c;
                if constexpr (Crit<T>::F32)
                    asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v[j]) : "l"(src));
                else
                    asm volatile("ld.global.nc.b16 %0, [%1];\n"
                                 : "=h"(reinterpret_cast<unsigned short&>(v[j])) : "l"(src));
            }
        }
    }
    __device__ __forceinline__ void store(T* x0, int gtid) const {
#pragma unroll
        for (int j = 0; j < N; ++j) {
            const int idx = gtid + j * Crit<T>::GT;
            x0[(idx / X0W) * Crit<T>::LX + idx % X0W] = v[j];
        }
    }
};

template <typename T, bool GAE>
__global__ void __launch_bounds__(Crit<T>::NTH, 1)
k2_critic(const T* __restrict__ staged, const T* __restrict__ wpad, Offs offs,
          const T* __restrict__ obsc, K2Args a) {
    using C = Crit<T>;
    using Net = CriticNet;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    T* sm = reinterpret_cast<T*>(smem_raw);
    float* gv = reinterpret_cast<float*>(smem_raw + C::fixed);   // [planes][EW]
    const int tid = threadIdx.x, rank = (int)cluster.block_rank();
    const int cid = blockIdx.x / C::CL, ncl = gridDim.x / C::CL;
    // this thread's warp group: its threads, buffers and mbarriers; the
    // group's mbarrier b counts the bytes the other blocks' same group sends
    // to its buffer b (xa, xb)
    const int grp = tid / C::GT, gtid = tid % C::GT;
    T* const gx = sm + C::XA + grp * C::GREG;   // xa, xb, x0 of the group
    T* const x0 = gx + 2 * C::TG * C::LA;
    const uint32_t mb = smem_u32(sm + C::MBAR) + 16 * grp;
    uint32_t rx[C::CL], rb[2][C::CL];
    for (int r = 0; r < C::CL; ++r) {
        rx[r] = mapa(smem_u32(gx), r);
        rb[0][r] = mapa(mb, r);
        rb[1][r] = mapa(mb + 8, r);
    }
    if (gtid == 0) {
        mbar_init(mb, 1);
        mbar_init(mb + 8, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // the block's share of each hidden layer's rows, and the last layer's
    // first W4R rows, from wpad; the biases from staged
    auto load_rows = [&](int off, int src, int rows, int l) {
        const int in = Net::inp(l), ld = C::lw(l);
        for (int idx = tid; idx < rows * (in / C::V16); idx += C::NTH) {
            const int o = idx / (in / C::V16), k = (idx % (in / C::V16)) * C::V16;
            const T* s = wpad + Net::wp(l) + (size_t)(src + o) * in + k;
            T* d = sm + off + o * ld + k;
            if constexpr (C::F32) {
#pragma unroll
                for (int u = 0; u < 4; ++u) cp_async4(d + u, s + u, true);
            } else {
                cp_async16(d, s, true);
            }
        }
    };
#pragma unroll
    for (int l = 0; l < 3; ++l) load_rows(C::wo(l), rank * C::outs(l), C::outs(l), l);
    load_rows(C::wo(3), 0, C::W4R, 3);
    cp_async_commit();
    for (int l = 0; l < 4; ++l)
        for (int o = tid; o < Net::out(l); o += C::NTH)
            sm[C::BIAS + Net::hsum(l) + o] = staged[offs.cb[l] + o];

    // the cluster's tiles: K2, group g = cid, + ncl, ... and in it plane
    // t = 0 .. T; K8, tile j = cid, + ncl, ...; warp group grp takes rows
    // [grp TG, + TG) of each
    const int planes = a.T + 1;
    const int units = GAE ? (a.B + C::TN - 1) / C::TN : (a.n_rows + C::TN - 1) / C::TN;
    const int mine = cid < units ? (units - cid + ncl - 1) / ncl : 0;
    const int ntile = GAE ? mine * planes : mine;
    auto tile_at = [&](int k, long& row0, int& nvalid) {
        if (GAE) {
            const int g = cid + (k / planes) * ncl, t = k % planes;
            row0 = (long)t * a.B + (long)g * C::TN + grp * C::TG;
            nvalid = a.B - g * C::TN - grp * C::TG;
        } else {
            row0 = (long)(cid + k * ncl) * C::TN + grp * C::TG;
            nvalid = (int)(a.n_rows - row0);
        }
    };
    // plane t's value of column col: in shared memory for t < splanes, past
    // them in the block's rows of the spill
    auto vslot = [&](int t, int col) -> float* {
        return t < a.splanes ? gv + t * C::EW + col
                             : a.spill + ((size_t)blockIdx.x * (planes - a.splanes)
                                          + (t - a.splanes)) * C::EW + col;
    };
    X0Regs<T> x0r;
    long row0 = 0;
    int nvalid = 0;
    if (ntile > 0) {
        tile_at(0, row0, nvalid);
        x0r.load(obsc, row0, nvalid, gtid);
    }
    cp_async_wait<0>();
    // the group's envs of env group g (EG a block), walked backwards in time
    // from the values in gv, a thread per env: the timeout bootstrap, delta,
    // the carry, the advantage and the return, as the reference computes
    // them; then the group's partial sums
    auto walk = [&](int g) {
        const int e = gtid, col = grp * C::EG + e;
        const long b = (long)g * C::TN + grp * C::TG + rank * C::EG + e;
        float sa = 0.0f, sa2 = 0.0f;
        if (e < C::EG && b < a.B) {
            float nextv = *vslot(a.T, col), carry = 0.0f;
            for (int t0 = a.T - 1; t0 >= 0; t0 -= 8) {
                float rw[8], nt[8], tf[8];
#pragma unroll
                for (int u = 0; u < 8; ++u) {
                    const size_t i = (size_t)(t0 - u) * a.B + b;
                    const bool in = t0 - u >= 0;
                    rw[u] = in ? a.rew[i] : 0.0f;
                    nt[u] = in ? a.nonterm[i] : 0.0f;
                    tf[u] = in ? a.timeout[i] : 0.0f;
                }
#pragma unroll
                for (int u = 0; u < 8; ++u) {
                    const int t = t0 - u;
                    if (t < 0) break;
                    const size_t i = (size_t)t * a.B + b;
                    const float v = *vslot(t, col);
                    const float rwd = tf[u] * v + (1.0f - tf[u]) * rw[u];
                    const float delta = rwd + a.gamma * nt[u] * nextv - v;
                    const float adv = delta + a.gamma * a.lam * nt[u] * carry;
                    carry = adv;
                    nextv = v;
                    a.adv[i] = adv;
                    a.ret[i] = v + adv;
                    sa += adv;
                    sa2 += adv * adv;
                }
            }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            sa += __shfl_xor_sync(0xffffffffu, sa, o);
            sa2 += __shfl_xor_sync(0xffffffffu, sa2, o);
        }
        if (gtid == 0) {   // visible on the card before the block arrives
            const int i = (g * C::CL + rank) * C::NG + grp;
            a.part[2 * i] = sa;
            a.part[2 * i + 1] = sa2;
            __threadfence();
        }
    };
    // tile k's last layer on the group's P0; K2 walks an env group after its
    // last plane.  Only the group's first warp takes part (one 16-row tile,
    // or EG f32 rows): the others go on to the next tile's first layer.
    auto finish = [&](int k, long r0, int nv) {
        const T* p0 = gx + (k & 1) * C::TG * C::LA;
        if (gtid >= 32) return;
        if constexpr (GAE) {
            const int t = k % planes;
            crit_value<T>(p0, sm + C::wo(3), sm + C::BIAS, rank, gtid,
                          [&](int e, float v) { *vslot(t, grp * C::EG + e) = v; });
            if (t < a.T) return;
            __syncwarp();   // the values' rows (shared memory and spill)
            walk(cid + (k / planes) * ncl);
        } else {
            crit_value<T>(p0, sm + C::wo(3), sm + C::BIAS, rank, gtid, [&](int e, float v) {
                const int n = rank * C::EG + e;
                if (n < nv) a.values[r0 + n] = v;
            });
        }
    };
    // a layer's outputs are in when the group's threads have written theirs
    // (its own block barrier), and, after the group has sent its columns to
    // the other blocks, their bytes have completed on the buffer's mbarrier
    int ph = 0;   // bit b: the parity of mbarrier b's current phase
    auto outputs_in = [&](int b, int l) {
        asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "n"(C::GT) : "memory");
        share_slice<T>(gx, b * C::TG * C::LA, C::outs(l), rank, rx, rb[b], gtid);
        if (gtid == 0) mbar_expect(mb + 8 * b, C::rx_bytes(l));
        mbar_wait(mb + 8 * b, (ph >> b) & 1);
        ph ^= 1 << b;
    };
    if (ntile > 0) x0r.store(x0, gtid);
    long r0 = row0, r0_prev = 0;
    int nv = nvalid, nv_prev = 0;
    if (ntile > 1) {
        tile_at(1, row0, nvalid);
        x0r.load(obsc, row0, nvalid, gtid);
    }
    // every block of the cluster has started, holds its weights and its
    // mbarriers, and the first x0 tiles are in
    cluster.sync();
    K2_CLK_START;
    // group 1 starts once group 0 has its first layer's outputs: from then on
    // one group's products tend to run while the other waits, where started
    // together they wait together (K2 0.188 against 0.206 ms: NVIDIA H100
    // 80GB HBM3, 700 W, prof_update --variant)
    if (grp == 1 && ntile > 0) asm volatile("bar.sync 3, %0;\n" ::"n"(2 * C::GT) : "memory");
    // Each group's tiles alternate its two buffers (P0 = buffer k % 2, P1
    // the other): tile k's first layer writes the P1 of tile k - 1, its
    // second layer the P0 of tile k - 1, whose last reader (tile k - 1's last
    // layer) runs here before tile k's first layer.  A group writes a buffer
    // of another block's same group only after it has received that group's
    // outputs of the layer that read the buffer last, so the data's own flow
    // orders every reuse.  The two groups of a block share only the weights.
    for (int k = 0; k < ntile; ++k) {
        const int b0 = k & 1, b1 = 1 - b0;
        T* const p0 = gx + b0 * C::TG * C::LA;
        T* const p1 = gx + b1 * C::TG * C::LA;
        if (k > 0) finish(k - 1, r0_prev, nv_prev);
        K2_CLK(0);
        crit_layer<T, 0>(x0, C::LX, sm + C::wo(0), sm + C::BIAS, p0, rank, gtid);
        K2_CLK(1);
        outputs_in(b0, 0);
        if (grp == 0 && k == 0) asm volatile("bar.arrive 3, %0;\n" ::"n"(2 * C::GT) : "memory");
        K2_CLK(2);
        crit_layer<T, 1>(p0, C::LA, sm + C::wo(1), sm + C::BIAS, p1, rank, gtid);
        K2_CLK(3);
        outputs_in(b1, 1);
        K2_CLK(4);
        crit_layer<T, 2>(p1, C::LA, sm + C::wo(2), sm + C::BIAS, p0, rank, gtid);
        K2_CLK(5);
        r0_prev = r0;
        nv_prev = nv;
        if (k + 1 < ntile) {   // x0 was last read by this tile's first layer
            x0r.store(x0, gtid);
            r0 = row0;
            nv = nvalid;
            if (k + 2 < ntile) {
                tile_at(k + 2, row0, nvalid);
                x0r.load(obsc, row0, nvalid, gtid);
            }
        }
        K2_CLK(6);
        outputs_in(b0, 2);
        K2_CLK(7);
    }
    if (ntile > 0) finish(ntile - 1, r0_prev, nv_prev);
    if constexpr (GAE) {
        // the last block to arrive adds the blocks' partials in order.  Each
        // partial's writer has fenced it; the barrier holds the arrival back
        // until both warp groups have (group 1 runs a layer behind group 0)
        __syncthreads();
        int last = 0;
        if (tid == 0) {
            __threadfence();
            last = atomicAdd(a.count, 1u) == gridDim.x - 1;
        }
        if (__syncthreads_or(last) && tid == 0) {
            __threadfence();
            const int np = units * C::CL * C::NG;
            float s1 = 0.0f, s2 = 0.0f;
            for (int i = 0; i < np; ++i) {
                s1 += __ldcg(a.part + 2 * i);
                s2 += __ldcg(a.part + 2 * i + 1);
            }
            a.sums[0] = s1;
            a.sums[1] = s2;
            *a.count = 0u;
        }
    }
}

// ---------------------------------------------------------------------------
// K3, pass 1.  A persistent block walks tiles blockIdx.x, + gridDim.x, ...:
// actor forward, the per-sample loss gradient, actor input gradients, then
// the same for the critic; x_l and dz_l of every layer go to the scratch
// (see ScratchOf), the per-sample sums (value loss, actor loss, both
// bound-loss halves, sum (mu - mu_old)^2 per action, dlogstd per action) to
// part_stats[blockIdx.x * NSTAT + slot].  The producer warp stages the
// weights of those products, tile after tile; each warp group takes its
// rows of every tile (the tile block's schedule, above).
//
// The loss means divide by n_total while the mask keeps the local row count
// n (a data-parallel rank passes the global count; K3 and K9 alike).
// ANCHOR makes it K9: the advantages are used as given (no mean, rstd),
// the old policy is always old_logp, no metric sum is formed (only the
// dlogstd slots), and each valid row's mu and value leave in type T
// through mu_t and val_t in place of mu_out and logp_out.
struct K3Args {
    const float *p, *act, *mu_old, *old_logp, *adv, *ret, *norm;
    float *part, *part_stats, *mu_out, *logp_out;
    void *mu_t, *val_t, *scratch;
    int self_old, n, n_total, stride, nslab, slab_rows;
    float lo, hi, bscale;
};

template <typename T, bool ANCHOR>
__global__ void __launch_bounds__(NT, 1)
k3_pass1(const T* __restrict__ staged, const T* __restrict__ wpad, Offs offs,
         const T* __restrict__ obsc, K3Args a) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    Smem<T> s(smem_raw);
    using S = Smem<T>;
    constexpr int TN = CT<T>::TN, TG = S::TG;
    const int tid = threadIdx.x;
    T* scr = static_cast<T*>(a.scratch);
    for (int i = tid; i < TN * NSTAT; i += NT) s.stat[i] = 0.0f;
    load_logstd<T>(s, a.p, offs.logstd);
    load_bias<T, ActorNet>(s, staged, offs.ab);
    load_bias<T, CriticNet>(s, staged, offs.cb);
    ring_init<T>(s);
    __syncthreads();
    const int ntiles = (a.n + TN - 1) / TN;
    Grp gp = grp_of<T>(tid);
    if (gp.g == NG) {   // the producer warp
        for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
            produce_fwd<T, ActorNet>(wpad, s, gp);
            produce_bwd<T, ActorNet>(wpad, s, gp);
            produce_fwd<T, CriticNet>(wpad, s, gp);
            produce_bwd<T, CriticNet>(wpad, s, gp);
        }
#if K3_CLOCKS
        clocks_out(gp);
#endif
        return;
    }
    const float mean = ANCHOR ? 0.0f : a.norm[0], rstd = ANCHOR ? 1.0f : a.norm[1];
    const float inv_n = 1.0f / (float)a.n_total;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        load_x0<T>(s, obsc, tile, a.n, gp);
        const long row0 = (long)tile * TN;
        store_rows<T, X0W>(s.x0, S::L0, scr, row0, a.n, gp);
        // the group's thread r < TG takes row r0 + r in the loss steps
        const int r = gp.r0 + gp.gtid;
        const long gi = row0 + r;
        const bool valid = gp.gtid < TG && gi < a.n;

        // ---- actor
        net_fwd<T, ActorNet>(s, gp, s.mu, scr, row0, a.n);
        if (gp.gtid < TG) {
            T* dz = s.dzl + r * S::LD;
            if (valid) {
                float* st = s.stat + r * NSTAT;
                const float adv = ANCHOR ? a.adv[gi] : (a.adv[gi] - mean) * rstd;
                float diff[NACT], mu[NACT];
                const float logp = row_logp<T>(s, r, a.act + gi * NACT, mu, diff);
                // self_old: the old policy is this forward itself
                const float old_lp = (!ANCHOR && a.self_old) ? logp : a.old_logp[gi];
                const float ratio = expf(logp - old_lp);
                const float ratio_c = fminf(fmaxf(ratio, a.lo), a.hi);
                const float surr = -adv * ratio, surr_c = -adv * ratio_c;
                const float gs = surr > surr_c ? 1.0f : (surr < surr_c ? 0.0f : 0.5f);
                const float cg = (ratio > a.lo ? 1.0f : (ratio == a.lo ? 0.5f : 0.0f))
                               * (ratio < a.hi ? 1.0f : (ratio == a.hi ? 0.5f : 0.0f));
                const float dratio = (gs + (1.0f - gs) * cg) * (-adv) * inv_n;
                const float dlogp = dratio * ratio;
#pragma unroll
                for (int k = 0; k < NACT; ++k) {
                    float dmu = dlogp * diff[k] / s.var[k];
                    const float b_hi = fmaxf(mu[k] - 1.0f, 0.0f);
                    const float b_lo = fminf(mu[k] + 1.0f, 0.0f);
                    dmu += (2.0f * b_hi + 2.0f * b_lo) * a.bscale;
                    dz[k] = CT<T>::from_f(dmu);
                    if constexpr (!ANCHOR) {
                        const float mo = a.self_old ? mu[k] : a.mu_old[gi * NACT + k];
                        st[2] += b_hi * b_hi;
                        st[3] += b_lo * b_lo;
                        st[4 + k] += (mu[k] - mo) * (mu[k] - mo);
                    }
                    st[4 + NACT + k] += dlogp * (diff[k] * diff[k] / s.var[k] - 1.0f);
                    if constexpr (ANCHOR) static_cast<T*>(a.mu_t)[gi * NACT + k] = CT<T>::from_f(mu[k]);
                    else a.mu_out[gi * NACT + k] = mu[k];
                }
#pragma unroll
                for (int k = NACT; k < DZ3W; ++k) dz[k] = CT<T>::from_f(0.0f);
                if constexpr (!ANCHOR) {
                    st[1] += fmaxf(surr, surr_c);
                    a.logp_out[gi] = logp;
                }
            } else {
#pragma unroll
                for (int k = 0; k < DZ3W; ++k) dz[k] = CT<T>::from_f(0.0f);
            }
        }
        K3_CLK(gp, C_LOSS);
        net_bwd<T, ActorNet>(s, gp, scr, row0, a.n);

        // ---- critic (its first epilogue writes z1, whose rows the group may
        // still be storing)
        group_bar(gp);
        net_fwd<T, CriticNet>(s, gp, s.val, scr, row0, a.n);
        if (gp.gtid < TG) {
            T* dz = s.dzl + r * S::LD;
#pragma unroll
            for (int k = 1; k < DZ3W; ++k) dz[k] = CT<T>::from_f(0.0f);
            float dval = 0.0f;
            if (valid) {
                const float e = s.val[r] - a.ret[gi];
                dval = 2.0f * e * inv_n;
                if constexpr (ANCHOR) static_cast<T*>(a.val_t)[gi] = CT<T>::from_f(s.val[r]);
                else s.stat[r * NSTAT] += e * e;
            }
            dz[0] = CT<T>::from_f(dval);
        }
        K3_CLK(gp, C_LOSS);
        net_bwd<T, CriticNet>(s, gp, scr, row0, a.n);
    }
    groups_end();
    if (tid < NSTAT) {
        float sum = 0.0f;
        for (int n = 0; n < TN; ++n) sum += s.stat[n * NSTAT + tid];
        a.part_stats[blockIdx.x * NSTAT + tid] = sum;
    }
#if K3_CLOCKS
    clocks_out(gp);
#endif
}

// K10: the actor forward and the log-prob of rows [0, n) of obsc through K3's
// own device code (net_fwd<ActorNet>, row_logp) and schedule; mu (f32) and
// logp out.
template <typename T>
__global__ void __launch_bounds__(NT, 1)
k10_policy_logp(const T* __restrict__ staged, const T* __restrict__ wpad, Offs offs,
                const T* __restrict__ obsc, const float* __restrict__ p,
                const float* __restrict__ act, int n, float* __restrict__ mu_out,
                float* __restrict__ logp_out) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    Smem<T> s(smem_raw);
    constexpr int TN = CT<T>::TN, TG = Smem<T>::TG;
    const int tid = threadIdx.x;
    load_logstd<T>(s, p, offs.logstd);
    load_bias<T, ActorNet>(s, staged, offs.ab);
    ring_init<T>(s);
    __syncthreads();
    const int ntiles = (n + TN - 1) / TN;
    Grp gp = grp_of<T>(tid);
    if (gp.g == NG) {   // the producer warp
        for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x)
            produce_fwd<T, ActorNet>(wpad, s, gp);
        return;
    }
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        load_x0<T>(s, obsc, tile, n, gp);
        group_bar(gp);
        net_fwd<T, ActorNet>(s, gp, s.mu, nullptr, 0, 0);
        const int r = gp.r0 + gp.gtid;
        const long gi = (long)tile * TN + r;
        if (gp.gtid < TG && gi < n) {
            float diff[NACT], mu[NACT];
            const float logp = row_logp<T>(s, r, act + gi * NACT, mu, diff);
#pragma unroll
            for (int k = 0; k < NACT; ++k) mu_out[gi * NACT + k] = mu[k];
            logp_out[gi] = logp;
        }
    }
    groups_end();
}

// ---------------------------------------------------------------------------
// K3, pass 2: dW_l = dz_l^T x_l and db_l = sum_rows dz_l of one P2T x P2T
// tile of one layer over one slab of rows [slab * slab_rows, + slab_rows),
// into the slab's partial part[slab * stride + flat index].  The tiles of
// all eight layers are numbered net by net, layer by layer, row tile by row
// tile (P2_TILES of them); block b takes slab b / P2_TILES, tile b %
// P2_TILES.  The rows stream through shared memory KR at a time, three steps
// in flight (cp.async).  bf16: 8 warps, each a 64 x 32 part of the tile on
// mma.sync, dz^T and x both read by ldmatrix.trans from their row-major
// tiles; f32: a thread 8 outputs by 8 inputs of FMAs.  The tile's sums stay
// in registers over the whole slab and are written once; the blocks of a
// layer's first column tile also sum the slab's dz rows in row order (db).
// Each row of a slab is read once per tile: the wider the tile, the fewer
// times a layer's rows cross L2.
constexpr int P2T = 128, P2_NT = 256, KR = 32, P2_STAGES = 3;
template <typename Net> constexpr HD int p2_tiles() {
    int t = 0;
    for (int l = 0; l < 4; ++l) t += ((scr_dzw<Net>(l) + P2T - 1) / P2T) * ((scr_xw<Net>(l) + P2T - 1) / P2T);
    return t;
}
constexpr int P2_TILES = p2_tiles<ActorNet>() + p2_tiles<CriticNet>();
template <typename T> struct P2 {
    static constexpr int LDS = P2T + CT<T>::PAD;  // row stride of a staged tile
    static constexpr int STG = 2 * KR * LDS;      // a step: dz rows, then x rows
    static constexpr size_t bytes = (size_t)P2_STAGES * STG * sizeof(T);
};

struct P2Tile { int dz, dzw, x, xw, out, in, w, b, m0, k0; };
template <typename Net>
__device__ __forceinline__ bool p2_find(int& t, const int* oW, const int* ob, P2Tile& r) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
        const int mt = (scr_dzw<Net>(l) + P2T - 1) / P2T, nt = (scr_xw<Net>(l) + P2T - 1) / P2T;
        if (t < mt * nt) {
            r = {scr_dz<Net>(l), scr_dzw<Net>(l), scr_x<Net>(l), scr_xw<Net>(l), Net::out(l),
                 Net::in(l), oW[l], ob[l], (t / nt) * P2T, (t % nt) * P2T};
            return true;
        }
        t -= mt * nt;
    }
    return false;
}

template <typename T>
__global__ void __launch_bounds__(P2_NT)
k3_pass2(const T* __restrict__ scr, int n, int slab_rows, Offs offs, float* __restrict__ part,
         int stride) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    T* sm = reinterpret_cast<T*>(smem_raw);
    constexpr int LDS = P2<T>::LDS, STG = P2<T>::STG, VEC = CT<T>::VEC, NV = P2T / VEC;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int slab = blockIdx.x / P2_TILES;
    int t = blockIdx.x % P2_TILES;
    P2Tile tl;
    if (!p2_find<ActorNet>(t, offs.aW, offs.ab, tl)) p2_find<CriticNet>(t, offs.cW, offs.cb, tl);
    const long r0 = (long)slab * slab_rows;
    const long r1 = r0 + slab_rows < n ? r0 + slab_rows : n;
    const int nsteps = r1 > r0 ? (int)((r1 - r0 + KR - 1) / KR) : 0;
    const T* DZ = scr + (size_t)tl.dz * n;
    const T* X = scr + (size_t)tl.x * n;
    auto stage = [&](int step) {
        T* dst = sm + (step % P2_STAGES) * STG;
        for (int idx = tid; idx < 2 * KR * NV; idx += P2_NT) {
            const int which = idx / (KR * NV), rem = idx % (KR * NV);
            const int rr = rem / NV, c = (rem % NV) * VEC;
            const long row = r0 + (long)step * KR + rr;
            const T* src;
            bool ok;
            if (which == 0) { ok = row < r1 && tl.m0 + c < tl.dzw; src = DZ + row * tl.dzw + tl.m0 + c; }
            else            { ok = row < r1 && tl.k0 + c < tl.xw;  src = X + row * tl.xw + tl.k0 + c; }
            cp_async16(dst + which * KR * LDS + rr * LDS + c, ok ? src : scr, ok);
        }
    };
    stage(0);
    cp_async_commit();
    stage(1);
    cp_async_commit();
    const bool bias = tl.k0 == 0 && tid < P2T;
    float bsum = 0.0f;
    float* G = part + (size_t)slab * stride;
    if constexpr (std::is_same<T, float>::value) {
        const int ty = tid >> 4, tx = tid & 15;    // outputs 8 ty .. + 8, inputs 8 tx .. + 8
        float acc[8][8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
        for (int step = 0; step < nsteps; ++step) {
            cp_async_wait<1>();
            __syncthreads();
            if (step + 2 < nsteps) stage(step + 2);
            cp_async_commit();
            const T* Ds = sm + (step % P2_STAGES) * STG;
            const T* Xs = Ds + KR * LDS;
#pragma unroll 2
            for (int rr = 0; rr < KR; ++rr) {
                float d[8], x[8];
#pragma unroll
                for (int i = 0; i < 8; ++i) d[i] = Ds[rr * LDS + ty * 8 + i];
#pragma unroll
                for (int j = 0; j < 8; ++j) x[j] = Xs[rr * LDS + tx * 8 + j];
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(d[i], x[j], acc[i][j]);
            }
            if (bias)
                for (int rr = 0; rr < KR; ++rr) bsum += Ds[rr * LDS + tid];
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int o = tl.m0 + ty * 8 + i, k = tl.k0 + tx * 8 + j;
                if (o < tl.out && k < tl.in) G[tl.w + o * tl.in + k] = acc[i][j];
            }
    } else {
        // warp: outputs wo .. + 64, inputs wi .. + 32
        const int wo = (warp >> 2) * 64, wi = (warp & 3) * 32;
        const bool works = tl.m0 + wo < tl.dzw && tl.k0 + wi < tl.xw;
        float acc[4][4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
        // ldmatrix.trans rows (this lane's row of the step) and columns
        const int ar = (lane & 7) + (lane >> 4) * 8, ac = ((lane >> 3) & 1) * 8;   // dz^T
        const int br = (lane & 7) + ((lane >> 3) & 1) * 8, bc = (lane >> 4) * 8;   // x
        for (int step = 0; step < nsteps; ++step) {
            cp_async_wait<1>();
            __syncthreads();
            if (step + 2 < nsteps) stage(step + 2);
            cp_async_commit();
            const T* Ds = sm + (step % P2_STAGES) * STG;
            const T* Xs = Ds + KR * LDS;
            if (works) {
#pragma unroll
                for (int kk = 0; kk < KR; kk += 16) {
                    uint32_t a[4][4], b[2][4];
#pragma unroll
                    for (int i = 0; i < 4; ++i) ldsm4t(a[i], Ds + (kk + ar) * LDS + wo + 16 * i + ac);
#pragma unroll
                    for (int jp = 0; jp < 2; ++jp) ldsm4t(b[jp], Xs + (kk + br) * LDS + wi + 16 * jp + bc);
#pragma unroll
                    for (int i = 0; i < 4; ++i)
#pragma unroll
                        for (int jp = 0; jp < 2; ++jp) {
                            mma16816(acc[i][2 * jp], a[i], b[jp][0], b[jp][1]);
                            mma16816(acc[i][2 * jp + 1], a[i], b[jp][2], b[jp][3]);
                        }
                }
            }
            if (bias)
                for (int rr = 0; rr < KR; ++rr) bsum += CT<T>::to_f(Ds[rr * LDS + tid]);
        }
        const int g = lane >> 2, q = lane & 3;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int o = tl.m0 + wo + 16 * i + g + (e >> 1) * 8;
                    const int k = tl.k0 + wi + 8 * j + 2 * q + (e & 1);
                    if (o < tl.out && k < tl.in) G[tl.w + o * tl.in + k] = acc[i][j][e];
                }
    }
    cp_async_wait<0>();
    if (bias && tl.m0 + tid < tl.out) G[tl.b + tl.m0 + tid] = bsum;
}

// K3, pass 3: the slabs' weight partials added in slab order into the flat
// gradient g, dlogstd and the 4 + NACT metric sums from the pass-1 blocks'
// stat partials in block order.
__global__ void __launch_bounds__(K4_NT)
k3_reduce(const float* __restrict__ part, int nslab, const float* __restrict__ part_stats,
          int nblk, int stride, int n_params, int logstd_off, float* __restrict__ g,
          float* __restrict__ stats) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n_params) {
        float sum = 0.0f;
        if (i >= logstd_off && i < logstd_off + NACT) {
            for (int b = 0; b < nblk; ++b) sum += part_stats[b * NSTAT + 4 + NACT + (i - logstd_off)];
        } else {
            for (int b = 0; b < nslab; ++b) sum += part[(size_t)b * stride + i];
        }
        g[i] = sum;
    }
    if (i < 4 + NACT) {
        float sum = 0.0f;
        for (int b = 0; b < nblk; ++b) sum += part_stats[b * NSTAT + i];
        stats[i] = sum;
    }
}

// ---------------------------------------------------------------------------
// K4 (opt_stage): the entropy coefficient on logstd, the global-norm clip,
// Adam at step cnt + 1 with lr read from device memory, and the copy of the
// new parameters in type T, in one launch of K4_BLOCKS blocks of
// K4_THREADS threads.  Each thread loads its share of g, m, v and p once,
// K4_VPT float4 vectors of each (thread t of the launch takes vectors t,
// t + threads, ...), all issued before the first is used, adds the
// coefficient on logstd and keeps them in registers; each block sums the
// squares of g in a fixed order (each thread's own in vector order, then a
// shuffle tree per warp, then warp 0 over the warps).  The launch is
// cooperative, its blocks all resident: the block sums go to a global
// partial [K4_BLOCKS], then grid.sync(), then thread 0 of every block adds
// them in block order, so every block sees the same norm bit for bit.  The
// clip and Adam then run on the values still in registers, and p', m', v'
// and staged are written once, 16 bytes a thread at a time.  A g longer than the
// registers hold (n > 4 K4_VPT K4_BLOCKS K4_THREADS) is read again past
// them; the last n % 4 values go one to a thread.
//
// What bounds it on an H100 (SXM, 3.35 TB/s): bytes, 5.34 MB at the T1
// networks' 177,945 parameters in bf16 (g, p, m, v read; p', m', v' and
// staged written): 1.6 us.  What holds it is the latency of one round of
// loads, the barrier, and one round of stores: more blocks put more bytes
// in flight and make the barrier dearer.  On an NVIDIA H100 80GB HBM3 at
// 700 W, 64 blocks measured fastest beside 32 and 132, and a 16-block
// cluster sharing the sums through distributed shared memory slower still
// (PERF.md, section 6).
#ifndef K4_BLOCKS
#define K4_BLOCKS 64
#endif
#ifndef K4_THREADS
#define K4_THREADS 256
#endif
#ifndef K4_VPT
#define K4_VPT 3         // float4 vectors of each of g, m, v, p a thread keeps
#endif
static_assert(K4_THREADS % 32 == 0 && K4_THREADS / 32 <= 32, "K4's warps");

struct K4Args {
    const float *g, *p, *m, *v, *lr;
    float *p2, *m2, *v2;
    float* part;     // [K4_BLOCKS] f32 scratch: the block sums
    int n, cnt, logstd_off;
    float entropy_coef, b1, omb1, b2, omb2, logb1, logb2, eps, max_norm;
};

// g[i] with the entropy coefficient added on logstd
__device__ __forceinline__ float k4_grad(const K4Args& a, int i, float x) {
    return (i >= a.logstd_off && i < a.logstd_off + NACT) ? x + a.entropy_coef : x;
}

__device__ __forceinline__ float4 k4_load(const K4Args& a, int j) {
    float4 x = reinterpret_cast<const float4*>(a.g)[j];
    x.x = k4_grad(a, 4 * j, x.x);
    x.y = k4_grad(a, 4 * j + 1, x.y);
    x.z = k4_grad(a, 4 * j + 2, x.z);
    x.w = k4_grad(a, 4 * j + 3, x.w);
    return x;
}

__device__ __forceinline__ float k4_sq4(float4 x, float s) {
    return fmaf(x.w, x.w, fmaf(x.z, x.z, fmaf(x.y, x.y, fmaf(x.x, x.x, s))));
}

// Adam on one value: (p', m', v') from g (clipped), m, v, p
struct K4Step { float scale, bc1, bc2, lr; };
__device__ __forceinline__ void k4_adam1(const K4Args& a, const K4Step& k, float g, float m,
                                         float v, float p, float& p2, float& m2, float& v2) {
    g *= k.scale;
    m2 = a.b1 * m + a.omb1 * g;
    v2 = a.b2 * v + a.omb2 * (g * g);
    p2 = p + (-k.lr) * ((m2 / k.bc1) / (sqrtf(v2 / k.bc2) + a.eps));
}

// vector j's update from its g, m, v, p
template <typename T>
__device__ __forceinline__ void k4_store4(const K4Args& a, const K4Step& k, int j, float4 g,
                                          float4 m, float4 v, float4 p, T* __restrict__ staged) {
    float4 p2, m2, v2;
    k4_adam1(a, k, g.x, m.x, v.x, p.x, p2.x, m2.x, v2.x);
    k4_adam1(a, k, g.y, m.y, v.y, p.y, p2.y, m2.y, v2.y);
    k4_adam1(a, k, g.z, m.z, v.z, p.z, p2.z, m2.z, v2.z);
    k4_adam1(a, k, g.w, m.w, v.w, p.w, p2.w, m2.w, v2.w);
    reinterpret_cast<float4*>(a.p2)[j] = p2;
    reinterpret_cast<float4*>(a.m2)[j] = m2;
    reinterpret_cast<float4*>(a.v2)[j] = v2;
    if constexpr (std::is_same<T, float>::value) {
        reinterpret_cast<float4*>(staged)[j] = p2;
    } else {
        __nv_bfloat162 lo, hi;
        lo.x = CT<T>::from_f(p2.x);
        lo.y = CT<T>::from_f(p2.y);
        hi.x = CT<T>::from_f(p2.z);
        hi.y = CT<T>::from_f(p2.w);
        uint2 u;
        u.x = *reinterpret_cast<uint32_t*>(&lo);
        u.y = *reinterpret_cast<uint32_t*>(&hi);
        reinterpret_cast<uint2*>(staged)[j] = u;
    }
}

template <typename T>
__global__ void __launch_bounds__(K4_THREADS, 1) k4_opt(K4Args a, T* __restrict__ staged) {
    namespace cg = cooperative_groups;
    __shared__ float warp_sq[K4_THREADS / 32];
    __shared__ float block_sq, total_sq;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nthr = K4_BLOCKS * K4_THREADS, gt = blockIdx.x * K4_THREADS + tid;
    const int n4 = a.n / 4, tail = 4 * n4 + gt;
    const float4* m4 = reinterpret_cast<const float4*>(a.m);
    const float4* v4 = reinterpret_cast<const float4*>(a.v);
    const float4* p4 = reinterpret_cast<const float4*>(a.p);
    float4 gr[K4_VPT], mr[K4_VPT], vr[K4_VPT], pr[K4_VPT];
#pragma unroll
    for (int u = 0; u < K4_VPT; ++u) {
        const int j = gt + u * nthr;
        if (j < n4) {
            gr[u] = k4_load(a, j);
            mr[u] = m4[j];
            vr[u] = v4[j];
            pr[u] = p4[j];
        }
    }
    float sq = 0.0f;
#pragma unroll
    for (int u = 0; u < K4_VPT; ++u)
        if (gt + u * nthr < n4) sq = k4_sq4(gr[u], sq);
    for (int j = gt + K4_VPT * nthr; j < n4; j += nthr) sq = k4_sq4(k4_load(a, j), sq);
    float g_tail = 0.0f;
    if (tail < a.n) {
        g_tail = k4_grad(a, tail, a.g[tail]);
        sq = fmaf(g_tail, g_tail, sq);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    if (lane == 0) warp_sq[warp] = sq;
    __syncthreads();
    if (warp == 0) {
        float w = lane < K4_THREADS / 32 ? warp_sq[lane] : 0.0f;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) w += __shfl_xor_sync(0xffffffffu, w, o);
        if (lane == 0) block_sq = w;
    }
    cg::grid_group grid = cg::this_grid();
    if (tid == 0) a.part[blockIdx.x] = block_sq;
    grid.sync();
    if (tid == 0) {
        float t = 0.0f;
        for (int b = 0; b < K4_BLOCKS; ++b) t += __ldcg(a.part + b);
        total_sq = t;
    }
    __syncthreads();
    const float g_norm = sqrtf(total_sq);
    const float cnt2 = (float)(a.cnt + 1);
    K4Step k;
    k.scale = g_norm < a.max_norm ? 1.0f : a.max_norm / g_norm;
    k.bc1 = 1.0f - expf(cnt2 * a.logb1);
    k.bc2 = 1.0f - expf(cnt2 * a.logb2);
    k.lr = a.lr[0];
#pragma unroll
    for (int u = 0; u < K4_VPT; ++u) {
        const int j = gt + u * nthr;
        if (j < n4) k4_store4<T>(a, k, j, gr[u], mr[u], vr[u], pr[u], staged);
    }
    for (int j = gt + K4_VPT * nthr; j < n4; j += nthr)
        k4_store4<T>(a, k, j, k4_load(a, j), m4[j], v4[j], p4[j], staged);
    if (tail < a.n) {
        float p2, m2, v2;
        k4_adam1(a, k, g_tail, a.m[tail], a.v[tail], a.p[tail], p2, m2, v2);
        a.p2[tail] = p2;
        a.m2[tail] = m2;
        a.v2[tail] = v2;
        staged[tail] = CT<T>::from_f(p2);
    }
}

// ---------------------------------------------------------------------------
static Offs make_offs(const int* o) {
    Offs f;
    for (int i = 0; i < 4; ++i) {
        f.aW[i] = o[i]; f.ab[i] = o[4 + i]; f.cW[i] = o[8 + i]; f.cb[i] = o[12 + i];
    }
    f.logstd = o[16];
    return f;
}

#define CHECK(call)                                   \
    do {                                              \
        const cudaError_t e_ = (call);                \
        if (e_ != cudaSuccess) return (int)e_;        \
    } while (0)

template <typename T>
static int pad_launch(const void* staged, const Offs& f, void* wpad, cudaStream_t st,
                      bool transposed) {
    const int n = transposed ? 2 * NWPAD : NWPAD;
    k_pad<T><<<(n + K4_NT - 1) / K4_NT, K4_NT, 0, st>>>((const T*)staged, f, (T*)wpad, n);
    return (int)cudaGetLastError();
}

template <typename Kernel>
static int allow_smem(Kernel k, size_t bytes) {
    return (int)cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// K2's and K8's launch: clusters of Crit<T>::CL blocks, nblk blocks in all
template <typename T, bool GAE>
static cudaLaunchConfig_t critic_config(int nblk, size_t bytes, cudaStream_t st,
                                        cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(nblk);
    cfg.blockDim = dim3(Crit<T>::NTH);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = st;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = Crit<T>::CL;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

template <typename T, bool GAE>
static int critic_launch(const void* staged, const Offs& f, const void* wpad, const void* obsc,
                         const K2Args& a, int nblk, cudaStream_t st) {
    const size_t bytes = Crit<T>::bytes(GAE ? a.splanes : 0);
    CHECK((cudaError_t)allow_smem(k2_critic<T, GAE>, bytes));
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = critic_config<T, GAE>(nblk, bytes, st, &attr);
    return (int)cudaLaunchKernelEx(&cfg, k2_critic<T, GAE>, (const T*)staged, (const T*)wpad, f,
                                   (const T*)obsc, a);
}

// ev: null, or three events recorded before the weight copy, after it and
// after the critic kernel (the parts' times, for measurement)
template <typename T>
static int gae_launch(const void* staged, const int* offs, void* wpad, const void* obsc,
                      K2Args a, int nblk, void* const* ev, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const Offs f = make_offs(offs);
    auto mark = [&](int i) { return ev ? cudaEventRecord((cudaEvent_t)ev[i], st) : cudaSuccess; };
    CHECK(mark(0));
    CHECK((cudaError_t)pad_launch<T>(staged, f, wpad, st, false));
    CHECK(mark(1));
    CHECK((cudaError_t)(critic_launch<T, true>(staged, f, wpad, obsc, a, nblk, st)));
    CHECK(mark(2));
    return 0;
}

template <typename T>
static int values_launch(const void* staged, const int* offs, void* wpad, const void* obsc,
                         int n_rows, float* values, int nblk, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const Offs f = make_offs(offs);
    K2Args a = {};
    a.values = values;
    a.n_rows = n_rows;
    CHECK((cudaError_t)pad_launch<T>(staged, f, wpad, st, false));
    return critic_launch<T, false>(staged, f, wpad, obsc, a, nblk, st);
}

// ev: null, or four events recorded before the weight copy and after pass
// 1, pass 2 and the reduce (the passes' times, for measurement)
template <typename T, bool ANCHOR>
static int grads_stats_launch(const void* staged, const int* offs, void* wpad, const void* obsc,
                              K3Args a, int n_params, float* g, float* stats, int nblk,
                              void* const* ev, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const Offs f = make_offs(offs);
    auto mark = [&](int i) { return ev ? cudaEventRecord((cudaEvent_t)ev[i], st) : cudaSuccess; };
    CHECK((cudaError_t)allow_smem(k3_pass1<T, ANCHOR>, Smem<T>::bytes));
    CHECK((cudaError_t)allow_smem(k3_pass2<T>, P2<T>::bytes));
    CHECK(mark(0));
    CHECK((cudaError_t)pad_launch<T>(staged, f, wpad, st, true));
    k3_pass1<T, ANCHOR><<<nblk, NT, Smem<T>::bytes, st>>>((const T*)staged, (const T*)wpad, f,
                                                          (const T*)obsc, a);
    CHECK(cudaGetLastError());
    CHECK(mark(1));
    k3_pass2<T><<<a.nslab * P2_TILES, P2_NT, P2<T>::bytes, st>>>(
        (const T*)a.scratch, a.n, a.slab_rows, f, a.part, a.stride);
    CHECK(cudaGetLastError());
    CHECK(mark(2));
    k3_reduce<<<(n_params + K4_NT - 1) / K4_NT, K4_NT, 0, st>>>(
        a.part, a.nslab, a.part_stats, nblk, a.stride, n_params, f.logstd, g, stats);
    CHECK(cudaGetLastError());
    CHECK(mark(3));
    return 0;
}

template <typename T>
static int policy_logp_launch(const void* staged, const int* offs, void* wpad, const void* obsc,
                              const float* p, const float* act, int n, float* mu, float* logp,
                              int nblk, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const Offs f = make_offs(offs);
    CHECK((cudaError_t)allow_smem(k10_policy_logp<T>, Smem<T>::bytes));
    CHECK((cudaError_t)pad_launch<T>(staged, f, wpad, st, true));
    k10_policy_logp<T><<<nblk, NT, Smem<T>::bytes, st>>>(
        (const T*)staged, (const T*)wpad, f, (const T*)obsc, p, act, n, mu, logp);
    return (int)cudaGetLastError();
}

// K4's one launch: a cooperative launch of K4_BLOCKS resident blocks
template <typename T>
static int opt_stage_launch(K4Args a, void* staged, void* stream) {
    T* out = (T*)staged;
    void* args[] = {&a, &out};
    return (int)cudaLaunchCooperativeKernel((const void*)k4_opt<T>, dim3(K4_BLOCKS),
                                            dim3(K4_THREADS), args, 0, (cudaStream_t)stream);
}

// A net's scratch layout: per layer x_l's offset and width, dz_l's offset
// and width, in values per row
template <typename Net> static void scratch_layout(int* out) {
    for (int l = 0; l < 4; ++l) {
        out[4 * l] = scr_x<Net>(l);
        out[4 * l + 1] = scr_xw<Net>(l);
        out[4 * l + 2] = scr_dz<Net>(l);
        out[4 * l + 3] = scr_dzw<Net>(l);
    }
}

constexpr int N_INFO = 18;   // values of info() before the scratch layout

template <typename T>
static int info(int* out) {
    using C = Crit<T>;
    out[0] = CT<T>::TN;
    out[1] = 2 * NWPAD;
    out[2] = SCR_WIDTH;
    out[3] = P2_TILES;
    out[4] = KR;
    out[5] = (int)Smem<T>::bytes;
    out[6] = (int)P2<T>::bytes;
    CHECK((cudaError_t)allow_smem(k3_pass1<T, false>, Smem<T>::bytes));
    CHECK((cudaError_t)allow_smem(k3_pass2<T>, P2<T>::bytes));
    CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[7], k3_pass1<T, false>, NT,
                                                        Smem<T>::bytes));
    CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[8], k3_pass2<T>, P2_NT,
                                                        P2<T>::bytes));
    out[9] = C::TN;
    out[10] = C::CL;
    out[11] = C::max_planes;
    out[12] = C::NTH;
    out[13] = C::NG;
    out[14] = K4_BLOCKS;
    out[15] = K4_THREADS;
    out[16] = DZ3W;
    out[17] = NSTAT;
    scratch_layout<ActorNet>(out + N_INFO);
    scratch_layout<CriticNet>(out + N_INFO + 16);
    return 0;
}

// K2's (planes = T + 1) or K8's (planes = 0) launch: its shared memory per
// block, and at that size the card's resident clusters and resident blocks
// per SM
template <typename T, bool GAE>
static int critic_info(int planes, int* out) {
    const size_t bytes = Crit<T>::bytes(planes);
    CHECK((cudaError_t)allow_smem(k2_critic<T, GAE>, bytes));
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = critic_config<T, GAE>(Crit<T>::CL, bytes, 0, &attr);
    out[0] = (int)bytes;
    CHECK(cudaOccupancyMaxActiveClusters(&out[1], k2_critic<T, GAE>, &cfg));
    CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], k2_critic<T, GAE>, Crit<T>::NTH,
                                                        bytes));
    return 0;
}

extern "C" {

#if K2_CLOCKS
// k2_critic's phase clocks summed over warps since the last call, then
// cleared: out[K2_NCLK]
int bg_k2_clocks(unsigned long long* out) {
    CHECK(cudaMemcpyFromSymbol(out, k2_clk, sizeof(k2_clk)));
    static const unsigned long long zeros[K2_NCLK] = {};
    return (int)cudaMemcpyToSymbol(k2_clk, zeros, sizeof(k2_clk));
}
#endif

#if K3_CLOCKS
// The tile block's phase clocks (k3_pass1, K9's and K10's) summed over
// warps since the last call, then cleared: out[K3_NCLK]
int bg_k3_clocks(unsigned long long* out) {
    CHECK(cudaMemcpyFromSymbol(out, k3_clk, sizeof(k3_clk)));
    static const unsigned long long zeros[K3_NCLK] = {};
    return (int)cudaMemcpyToSymbol(k3_clk, zeros, sizeof(k3_clk));
}
#endif

// out[N_INFO + 32]: samples per tile of a tile block, padded weight values
// (wpad: the layers and their transposes), scratch values per row, pass-2 tiles, pass-2 rows per step, the
// shared memory of a tile block and of a pass-2 block, K3's pass-1 and
// pass-2 resident blocks per SM; K2's and K8's rows per tile, blocks per
// cluster, most planes (T + 1) of values in shared memory, threads per block
// and warp groups per block; K4's blocks and threads per block; the last
// layer's padded dz width and the stat slots per sample (both from NACT);
// then the scratch layout of the actor's four layers and the
// critic's (x offset, x width, dz offset, dz width each)
int bg_update_info(int bf16, int* out) {
    return bf16 ? info<__nv_bfloat16>(out) : info<float>(out);
}

// out[3]: K2's launch at `planes` = T + 1 planes (at most max_planes: the
// planes in shared memory), or K8's at 0: shared memory per block, resident
// clusters on the card, resident blocks per SM
int bg_critic_info(int bf16, int planes, int* out) {
    const int most = bf16 ? Crit<__nv_bfloat16>::max_planes : Crit<float>::max_planes;
    if (planes < 0 || planes > most) return (int)cudaErrorInvalidValue;
    if (bf16)
        return planes ? critic_info<__nv_bfloat16, true>(planes, out)
                      : critic_info<__nv_bfloat16, false>(0, out);
    return planes ? critic_info<float, true>(planes, out) : critic_info<float, false>(0, out);
}

// wpad: [2 NWPAD] of type T scratch (K2 uses the first NWPAD); part: [2 * ceil(B / rows per tile) *
// blocks per cluster * warp groups] f32 scratch; count: one unsigned, 0 before the first
// call (each call leaves it 0); spill: for T + 1 > max_planes, [nblk * (T + 1 -
// max_planes) * rows per tile / blocks per cluster] f32 scratch, else null; nblk:
// a multiple of the cluster's blocks; ev: null, or three CUDA events that
// time the weight copy and the critic kernel (gae_launch)
int bg_gae(int bf16, const void* staged, const int* offs, void* wpad, const void* obsc,
           const float* rew, const float* nonterm, const float* timeout, float* part,
           unsigned* count, float* spill, float* adv, float* ret, float* sums, int T_, int B,
           float gamma, float lam, int nblk, void* const* ev, void* stream) {
    const int most = bf16 ? Crit<__nv_bfloat16>::max_planes : Crit<float>::max_planes;
    K2Args a = {};
    a.rew = rew; a.nonterm = nonterm; a.timeout = timeout; a.adv = adv; a.ret = ret;
    a.part = part; a.sums = sums; a.count = count; a.T = T_; a.B = B; a.gamma = gamma;
    a.lam = lam;
    a.splanes = T_ + 1 < most ? T_ + 1 : most;
    a.spill = spill;
    if (T_ < 1 || B < 1 || (a.splanes < T_ + 1 && spill == nullptr))
        return (int)cudaErrorInvalidValue;
    return bf16 ? gae_launch<__nv_bfloat16>(staged, offs, wpad, obsc, a, nblk, ev, stream)
                : gae_launch<float>(staged, offs, wpad, obsc, a, nblk, ev, stream);
}

// wpad as for bg_gae; scratch: [n * SCR_WIDTH] of type T; part: [nslab *
// stride] f32, part_stats: [nblk * NSTAT] f32 scratch; slab s holds rows
// [s * slab_rows, min((s + 1) * slab_rows, n)); ev: null, or four CUDA
// events that time the passes (grads_stats_launch)
int bg_grads_stats(int bf16, const void* staged, const float* p, const int* offs, void* wpad,
                   const void* obsc, const float* act, const float* mu_old, const float* old_logp,
                   const float* adv, const float* ret, const float* norm, int self_old, int n,
                   int n_total, float lo, float hi, float bscale, void* scratch, float* part,
                   float* part_stats, int stride, int nslab, int slab_rows, int n_params,
                   float* g, float* stats, float* mu_out, float* logp_out, int nblk,
                   void* const* ev, void* stream) {
    K3Args a;
    a.p = p; a.act = act; a.mu_old = mu_old; a.old_logp = old_logp; a.adv = adv; a.ret = ret;
    a.norm = norm; a.part = part; a.part_stats = part_stats; a.mu_out = mu_out;
    a.logp_out = logp_out; a.mu_t = nullptr; a.val_t = nullptr; a.scratch = scratch;
    a.self_old = self_old; a.n = n; a.n_total = n_total; a.stride = stride; a.nslab = nslab;
    a.slab_rows = slab_rows; a.lo = lo; a.hi = hi; a.bscale = bscale;
    return bf16 ? grads_stats_launch<__nv_bfloat16, false>(staged, offs, wpad, obsc, a, n_params,
                                                           g, stats, nblk, ev, stream)
                : grads_stats_launch<float, false>(staged, offs, wpad, obsc, a, n_params, g,
                                                   stats, nblk, ev, stream);
}

// K8: critic values of rows [0, n_rows) of obsc; nblk as for bg_gae
int bg_values(int bf16, const void* staged, const int* offs, void* wpad, const void* obsc,
              int n_rows, float* values, int nblk, void* stream) {
    return bf16 ? values_launch<__nv_bfloat16>(staged, offs, wpad, obsc, n_rows, values, nblk,
                                               stream)
                : values_launch<float>(staged, offs, wpad, obsc, n_rows, values, nblk, stream);
}

// K9: the scratches as for bg_grads_stats; stats: [4 + NACT] f32 scratch,
// which the reduce fills with zeros (K9 forms no metric sums); mu_t [n,
// NACT] and val_t [n] in type T
int bg_grads(int bf16, const void* staged, const float* p, const int* offs, void* wpad,
             const void* obsc, const float* act, const float* old_logp, const float* adv,
             const float* ret, int n, int n_total, float lo, float hi, float bscale, void* scratch,
             float* part, float* part_stats, int stride, int nslab, int slab_rows, int n_params,
             float* g, float* stats, void* mu_t, void* val_t, int nblk, void* stream) {
    K3Args a;
    a.p = p; a.act = act; a.mu_old = nullptr; a.old_logp = old_logp; a.adv = adv; a.ret = ret;
    a.norm = nullptr; a.part = part; a.part_stats = part_stats; a.mu_out = nullptr;
    a.logp_out = nullptr; a.mu_t = mu_t; a.val_t = val_t; a.scratch = scratch; a.self_old = 0;
    a.n = n; a.n_total = n_total; a.stride = stride; a.nslab = nslab; a.slab_rows = slab_rows;
    a.lo = lo; a.hi = hi; a.bscale = bscale;
    return bf16 ? grads_stats_launch<__nv_bfloat16, true>(staged, offs, wpad, obsc, a, n_params, g,
                                                          stats, nblk, nullptr, stream)
                : grads_stats_launch<float, true>(staged, offs, wpad, obsc, a, n_params, g, stats,
                                                  nblk, nullptr, stream);
}

// K10: mu [n, NACT] and logp [n] f32 of rows [0, n) of obsc and act
int bg_policy_logp(int bf16, const void* staged, const float* p, const int* offs, void* wpad,
                   const void* obsc, const float* act, int n, float* mu, float* logp, int nblk,
                   void* stream) {
    return bf16 ? policy_logp_launch<__nv_bfloat16>(staged, offs, wpad, obsc, p, act, n, mu, logp,
                                                    nblk, stream)
                : policy_logp_launch<float>(staged, offs, wpad, obsc, p, act, n, mu, logp, nblk,
                                            stream);
}

// g, p, m, v, p2, m2, v2 [n] f32 and staged [n] of type T, 16-byte aligned;
// part: [k4_blocks] f32 scratch (the block sums)
int bg_opt_stage(int bf16, const float* g, const float* p, const float* m, const float* v,
                 const float* lr, int cnt, int logstd_off, int n, float entropy_coef, float b1,
                 float omb1, float b2, float omb2, float logb1, float logb2, float eps,
                 float max_norm, float* part, float* p2, float* m2, float* v2, void* staged,
                 void* stream) {
    K4Args a;
    a.g = g; a.p = p; a.m = m; a.v = v; a.lr = lr; a.part = part; a.p2 = p2; a.m2 = m2; a.v2 = v2;
    a.n = n; a.cnt = cnt; a.logstd_off = logstd_off; a.entropy_coef = entropy_coef;
    a.b1 = b1; a.omb1 = omb1; a.b2 = b2; a.omb2 = omb2; a.logb1 = logb1; a.logb2 = logb2;
    a.eps = eps; a.max_norm = max_norm;
    return bf16 ? opt_stage_launch<__nv_bfloat16>(a, staged, stream)
                : opt_stage_launch<float>(a, staged, stream);
}

}  // extern "C"
