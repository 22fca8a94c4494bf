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
// values is 16 aligned bytes that cp.async can fetch.
//
// What bounds them on this card.  K2 and K3 are bound by operations
// (2.3e5 and 1.0e6 flop per sample against 0.1 to 0.4 KB).  K2 and K8 run
// their own forward-only critic kernel, k2_critic (its design is at the
// kernel).  K3's tile block (16 warps, one per SM; also K10's) keeps one
// tile of samples (64 in bf16, 32 in f32 at the T1 networks' widths;
// tile_rows halves it where the block would not fit, 32 and 16 at
// T1Standup's 434-wide critic input) with every layer's activations in
// shared memory; weights stream through L2 in chunks of 32 (bf16) or 16
// (f32) reduction rows, double-buffered with cp.async, one block barrier per
// chunk.  K3 (and K9) is three passes, all on the caller's stream:
//   pass 1 (k3_pass1)  per tile: forward, the per-row loss step, the input
//                      gradients of both nets; every layer's input x_l and
//                      output gradient dz_l leave as rows in type T, by bulk
//                      copies that run on while the block computes, to a
//                      scratch in device memory (2,400 values per row at
//                      the T1 widths), and
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
// partials, most of its 4.7 ms).  What bounds K3 now is pass 1: one block
// per SM runs its 14 products, their weight chunks from L2 (each tile
// restages all weights, ~0.7 MB per 64 rows), the epilogues and the scratch
// stores in lock step, so each of those costs about as much as the tensor
// work; then pass 2's reads of the scratch (0.47 GB bf16 at 98,304 rows).
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
constexpr int NT = 512;                       // threads of a tile block (one per SM)
constexpr int NW = NT / 32;                   // its warps
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
// tsize bytes with CT's kc, st and pad
constexpr size_t tile_bytes(int tn, int kc, int st, int pad, int tsize) {
    const int kp = tsize == 4 ? kc + 1 : kc;
    const int n_ws = cmax(256 * kp, kc * (256 + pad));
    const size_t n_t = (size_t)tn * (X0W + HB1 + HB2 + HB3 + HBA + HB2 + 6 * pad) + st * n_ws
                       + rup(NBIAS, 8);
    const size_t n_f = (size_t)tn * (NACT + 1 + NSTAT) + 2 * NACT;
    return ((n_t * tsize + 127) / 128) * 128 + n_f * 4;
}
// A tile's samples: tn, halved while the block does not fit (down to 16).
// The T1 networks keep 64 in bf16 and 32 in f32; a 434-wide critic input
// takes 32 and 16.
constexpr int tile_rows(int tn, int kc, int st, int pad, int tsize) {
    return tn <= 16 || tile_bytes(tn, kc, st, pad, tsize) <= SMEM_MAX
               ? tn : tile_rows(tn / 2, kc, st, pad, tsize);
}

template <typename T> struct CT;
// TN: samples in a tile (tile_rows); KC: reduction rows of a staged weight
// chunk, ST of them in flight (more stages and shorter chunks measured
// slower on the H100); PAD: what a shared-memory row stride adds to its
// width (multiples of 16 bytes, and for bf16 an odd number of 16-byte
// units, so the 8 rows an ldmatrix reads fall in different banks); VEC:
// values in 16 bytes
template <> struct CT<float> {
    static constexpr int KC = 16, ST = 2, PAD = 4, VEC = 4;
    static constexpr int TN = tile_rows(32, KC, ST, PAD, 4);
    static __device__ __forceinline__ float to_f(float x) { return x; }
    static __device__ __forceinline__ float from_f(float x) { return x; }
};
template <> struct CT<__nv_bfloat16> {
    static constexpr int KC = 32, ST = 2, PAD = 8, VEC = 8;   // KC 32: swz
    static constexpr int TN = tile_rows(64, KC, ST, PAD, 2);
    static __device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
    static __device__ __forceinline__ __nv_bfloat16 from_f(float x) { return __float2bfloat16_rn(x); }
};
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
// Shared memory of a tile block (K3's pass 1, K10).  Row
// strides are the widths plus PAD.  The x of layers 1 and 3 share xa; z_l
// holds the pre-activation and then, in the backward, dz of that layer; the
// last layer's dz (dzl) lies in xb, free once the forward is done.
template <typename T> struct Smem {
    static constexpr int TN = CT<T>::TN, P = CT<T>::PAD;
    static constexpr int L0 = X0W + P, LZ1 = HB1 + P, LZ2 = HB2 + P, LZ3 = HB3 + P, LA = HBA + P,
                         LB = HB2 + P, LD = DZ3W + P;
    // a staged chunk: FWD [CW][KP] or !FWD [KC][CW + PAD], ST of them; f32's
    // FWD rows are KC + 1 apart, bf16's KC apart with their 16-byte units
    // swizzled (swz)
    static constexpr int KP = std::is_same<T, float>::value ? CT<T>::KC + 1 : CT<T>::KC;
    static constexpr int n_ws = cmax(256 * KP, CT<T>::KC * (256 + P));
    static constexpr size_t n_t = (size_t)TN * (L0 + LZ1 + LZ2 + LZ3 + LA + LB) + CT<T>::ST * n_ws
                                  + rup(NBIAS, 8);
    static constexpr size_t n_f = (size_t)TN * (NACT + 1 + NSTAT) + 2 * NACT;
    static constexpr size_t bytes = ((n_t * sizeof(T) + 127) / 128) * 128 + n_f * sizeof(float);
    T *x0, *z1, *z2, *z3, *xa, *xb, *dzl, *ws, *bias;
    float *mu, *val, *stat, *logstd, *var;
    __device__ Smem(unsigned char* raw) {
        T* p = reinterpret_cast<T*>(raw);
        x0 = p; p += TN * L0;
        z1 = p; p += TN * LZ1;
        z2 = p; p += TN * LZ2;
        z3 = p; p += TN * LZ3;
        xa = p; p += TN * LA;
        xb = p; p += TN * LB;
        dzl = xb;
        ws = p; p += CT<T>::ST * n_ws;
        bias = p;
        float* f = reinterpret_cast<float*>(raw + ((n_t * sizeof(T) + 127) / 128) * 128);
        mu = f; f += TN * NACT;
        val = f; f += TN;
        stat = f; f += TN * NSTAT;
        logstd = f; f += NACT;
        var = f;
    }
};
static_assert(Smem<float>::bytes <= SMEM_MAX, "f32 tile exceeds a block's shared memory");
static_assert(Smem<__nv_bfloat16>::bytes <= SMEM_MAX, "bf16 tile exceeds a block's shared memory");
static_assert(Smem<float>::bytes == tile_bytes(CT<float>::TN, 16, 2, 4, 4)
              && Smem<__nv_bfloat16>::bytes == tile_bytes(CT<__nv_bfloat16>::TN, 32, 2, 8, 2),
              "tile_bytes must be Smem's size");
static_assert(Smem<float>::LD <= Smem<float>::LB && Smem<__nv_bfloat16>::LD <= Smem<__nv_bfloat16>::LB,
              "dzl must fit in xb");

// ---------------------------------------------------------------------------
// PTX: cp.async (16 or 4 bytes; src_bytes 0 fills zeros), ldmatrix, mma.sync
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ uint64_t policy_evict_first() {
    uint64_t p;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
    return p;
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
// shared -> global bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) on the async proxy: the thread goes on at once; its smem source
// may be written again after bulk_wait_read, and a fence.proxy.async by the
// writers (then a barrier) must come between their writes and the copy.  The
// lines it writes are marked to leave L2 first: left to L2's own policy, the
// 0.47 GB of scratch rows that stream through it cost pass 1 another 0.38 ms
// (NVIDIA H100 80GB HBM3, 700 W, prof_update --variant)
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;\n"
                 ::"l"(dst), "r"(smem_u32(src)), "r"(bytes), "l"(policy_evict_first()) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
// The 16-byte unit u (of 4) of row c of a bf16 FWD chunk [CW][32] lies at
// unit swz(c, u): the 8 rows an ldmatrix reads then fall in 8 different
// bank groups, with no padding
__device__ __forceinline__ int swz(int c, int u) { return u ^ ((c >> 1) & 3); }
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
// For every sample n of the tile and every column c < CW = 32 J:
//     epi(n, c, sum_{r < R} A[n * lda + r] * B[r][c])
// FWD:  B[r][c] = Wp[c * ldw + r]   (r over inputs, c over outputs: x W^T)
// !FWD: B[r][c] = Wp[r * ldw + c]   (r over outputs, c over inputs: dz W)
// Wp is one layer of wpad, `rows` rows of ldw; R is a multiple of 16.  B is
// staged through shared memory KC values of r at a time, ST chunks in
// flight (cp.async), zero past Wp's rows and past R; A is read only below R.
// epi sees columns past B's end (as 0) and must skip them.
// f32: FMAs, a warp takes TN / NW samples, a lane every 32nd column.
// bf16: mma.sync m16n8k16; warp w owns MT row tiles of 16 and NW8 column
// tiles of 8, and its epilogue reads the accumulators where the mma left
// them.
template <typename T, int J, bool FWD, typename Epi>
__device__ __forceinline__ void gemm_epi(const T* A, int lda, const T* __restrict__ Wp, int ldw,
                                         int rows, int R, const Smem<T>& s, Epi epi) {
    constexpr int TN = CT<T>::TN, KC = CT<T>::KC, CW = J * 32, VEC = CT<T>::VEC;
    constexpr bool F32 = std::is_same<T, float>::value;
    constexpr int KP = Smem<T>::KP;                 // row stride of a [CW][KC] chunk
    constexpr int CP = CW + CT<T>::PAD;             // row stride of a [KC][CW] chunk
    constexpr int WS = Smem<T>::n_ws, ST = CT<T>::ST;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nch = (R + KC - 1) / KC;
    auto stage = [&](int ch) {
        T* dst = s.ws + (ch % ST) * WS;
        const int k0 = ch * KC;
        if (F32 && FWD) {
            for (int idx = tid; idx < CW * KC; idx += NT) {
                const int c = idx / KC, rr = idx % KC;
                const bool ok = c < rows && k0 + rr < R;
                cp_async4(dst + c * KP + rr, ok ? Wp + (size_t)c * ldw + k0 + rr : Wp, ok);
            }
        } else if (FWD) {
            for (int idx = tid; idx < CW * (KC / VEC); idx += NT) {
                const int c = idx / (KC / VEC), v = idx % (KC / VEC);
                const bool ok = c < rows && k0 + v * VEC < R;
                cp_async16(dst + c * KP + swz(c, v) * VEC,
                           ok ? Wp + (size_t)c * ldw + k0 + v * VEC : Wp, ok);
            }
        } else {
            for (int idx = tid; idx < KC * (CW / VEC); idx += NT) {
                const int rr = idx / (CW / VEC), v = idx % (CW / VEC);
                const bool ok = k0 + rr < R;
                cp_async16(dst + rr * CP + v * VEC, ok ? Wp + (size_t)(k0 + rr) * ldw + v * VEC : Wp, ok);
            }
        }
    };
    // the previous product's reads of the chunk buffers and its epilogue's
    // writes are done before anything here; this thread's bulk copies out of
    // shared memory (store_rows) have read their rows before the first chunk's
    // barrier, so the epilogue may overwrite them
    __syncthreads();
    for (int c = 0; c < ST - 1; ++c) {
        if (c < nch) stage(c);
        cp_async_commit();
    }
    if constexpr (F32) {
        constexpr int NS = TN / NW;
        float acc[NS][J];
#pragma unroll
        for (int i = 0; i < NS; ++i)
#pragma unroll
            for (int j = 0; j < J; ++j) acc[i][j] = 0.0f;
        for (int ch = 0; ch < nch; ++ch) {
            if (ch == 0) bulk_wait_read();
            cp_async_wait<ST - 2>();
            __syncthreads();
            if (ch + ST - 1 < nch) stage(ch + ST - 1);
            cp_async_commit();
            const T* Ws = s.ws + (ch % ST) * WS;
            const int k0 = ch * KC;
#pragma unroll 4
            for (int rr = 0; rr < KC; ++rr) {
                float a[NS], b[J];
#pragma unroll
                for (int i = 0; i < NS; ++i) a[i] = A[(warp * NS + i) * lda + k0 + rr];
#pragma unroll
                for (int j = 0; j < J; ++j) b[j] = FWD ? Ws[(lane + 32 * j) * KP + rr] : Ws[rr * CP + lane + 32 * j];
#pragma unroll
                for (int i = 0; i < NS; ++i)
#pragma unroll
                    for (int j = 0; j < J; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
            }
        }
#pragma unroll
        for (int j = 0; j < J; ++j)
#pragma unroll
            for (int i = 0; i < NS; ++i) epi(warp * NS + i, lane + 32 * j, acc[i][j]);
    } else {
        // NCG column groups of NW8 8-wide tiles, NRG row groups of MT 16-row
        // tiles; warps past NCG * NRG only stage and wait
        constexpr int NW8 = CW >= 128 ? 4 : 2;
        constexpr int NCG = CW / (8 * NW8);
        constexpr int NRG = (NW / NCG) < TN / 16 ? NW / NCG : TN / 16;
        constexpr int MT = (TN / 16) / NRG;
        static_assert(NCG * NRG <= NW && MT * NRG * 16 == TN, "warp tiling");
        const bool works = warp < NCG * NRG;
        const int m0 = (warp / NCG) * MT * 16, n0 = (warp % NCG) * NW8 * 8;
        float acc[MT][NW8][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int j = 0; j < NW8; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
        // this lane's row and column within the 8 x 8 matrices of an ldmatrix
        const int lr = (lane & 7) + ((lane >> 3) & 1) * 8, lc = (lane >> 4) * 8;   // A, !FWD B
        const int fr = (lane & 7) + (lane >> 4) * 8, fc = ((lane >> 3) & 1) * 8;   // FWD B
        for (int ch = 0; ch < nch; ++ch) {
            if (ch == 0) bulk_wait_read();
            cp_async_wait<ST - 2>();
            __syncthreads();
            if (ch + ST - 1 < nch) stage(ch + ST - 1);
            cp_async_commit();
            if (!works) continue;
            const T* Ws = s.ws + (ch % ST) * WS;
            const int k0 = ch * KC;
#pragma unroll
            for (int kk = 0; kk < KC; kk += 16) {
                if (k0 + kk >= R) break;
                uint32_t a[MT][4];
#pragma unroll
                for (int i = 0; i < MT; ++i) ldsm4(a[i], A + (m0 + 16 * i + lr) * lda + k0 + kk + lc);
#pragma unroll
                for (int jp = 0; jp < NW8 / 2; ++jp) {
                    uint32_t b[4];
                    const int c = n0 + 16 * jp + fr;
                    if (FWD) ldsm4(b, Ws + c * KP + swz(c, (kk + fc) / 8) * 8);
                    else     ldsm4t(b, Ws + (kk + lr) * CP + n0 + 16 * jp + lc);
#pragma unroll
                    for (int i = 0; i < MT; ++i) {
                        mma16816(acc[i][2 * jp], a[i], b[0], b[1]);
                        mma16816(acc[i][2 * jp + 1], a[i], b[2], b[3]);
                    }
                }
            }
        }
        if (works) {
            const int g = lane >> 2, t = lane & 3;
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
                for (int j = 0; j < NW8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        epi(m0 + 16 * i + g + (e >> 1) * 8, n0 + 8 * j + 2 * t + (e & 1), acc[i][j][e]);
        }
    }
}

// Rows [row0, row0 + TN) of the tile buffer S (stride lds) into G [n][W],
// rows past n left out: thread r copies row r with one bulk copy, which runs
// on while the block goes on (the next product waits for its reads).
template <typename T>
__device__ __forceinline__ void store_rows(const T* S, int lds, T* __restrict__ G, int W, long row0,
                                           int n) {
    fence_proxy_async();
    __syncthreads();
    const int r = threadIdx.x;
    if (r < CT<T>::TN && row0 + r < n) bulk_store(G + (row0 + r) * W, S + r * lds, W * (int)sizeof(T));
}

// One dense layer L of Net: z = round_T(x W^T) + b in T; hidden layers keep z
// and ELU(z) (both T), the last layer writes z as f32 to outf[n * ldo + o].
template <typename T, typename Net, int L>
__device__ __forceinline__ void layer_fwd(const Smem<T>& s, const T* X, int ldx,
                                          const T* __restrict__ wpad, T* Z, int ldz, T* Xn,
                                          int ldn, float* outf, int ldo) {
    constexpr int OUT = Net::out(L);
    constexpr bool LAST = L == 3;
    const T* b = s.bias + bias_off<Net>(L);
    gemm_epi<T, (OUT + 31) / 32, true>(X, ldx, wpad + Net::wp(L), Net::inp(L), Net::outp(L),
                                       Net::inp(L), s, [&](int n, int o, float acc) {
        if (o >= OUT) return;
        const float z = rnd<T>(rnd<T>(acc) + CT<T>::to_f(b[o]));
        if (LAST) {
            outf[n * ldo + o] = z;
        } else {
            Z[n * ldz + o] = CT<T>::from_f(z);
            Xn[n * ldn + o] = CT<T>::from_f(z > 0.0f ? z : expf(z) - 1.0f);
        }
    });
}

// The forward of one net on the tile in s.x0; with a scratch (K3's pass 1)
// each hidden layer's output x_l (the next layer's input) also goes to its
// rows there.  (Not inlined, like net_bwd: each then gets registers of its
// own, and the one giant function they would make spills.)
template <typename T, typename Net>
__device__ __noinline__ void net_fwd(const Smem<T>& s, const T* __restrict__ wpad, float* outf,
                                     T* scr, long row0, int n) {
    using S = Smem<T>;
    layer_fwd<T, Net, 0>(s, s.x0, S::L0, wpad, s.z1, S::LZ1, s.xa, S::LA, nullptr, 0);
    if (scr) store_rows<T>(s.xa, S::LA, scr + (size_t)scr_x<Net>(1) * n, Net::H1, row0, n);
    layer_fwd<T, Net, 1>(s, s.xa, S::LA, wpad, s.z2, S::LZ2, s.xb, S::LB, nullptr, 0);
    if (scr) store_rows<T>(s.xb, S::LB, scr + (size_t)scr_x<Net>(2) * n, Net::H2, row0, n);
    layer_fwd<T, Net, 2>(s, s.xb, S::LB, wpad, s.z3, S::LZ3, s.xa, S::LA, nullptr, 0);
    if (scr) store_rows<T>(s.xa, S::LA, scr + (size_t)scr_x<Net>(3) * n, Net::H3, row0, n);
    layer_fwd<T, Net, 3>(s, s.xa, S::LA, wpad, nullptr, 0, nullptr, 0, outf, Net::DO);
}

// dz_prev = round_T(dz W) * ELU'(z_prev) of layer L, written over z_prev
template <typename T, typename Net, int L>
__device__ __forceinline__ void layer_bwd_input(const Smem<T>& s, const T* DZ, int ldd,
                                                const T* __restrict__ wpad, T* Zp, int ldp) {
    constexpr int IN = Net::in(L);
    gemm_epi<T, IN / 32, false>(DZ, ldd, wpad + Net::wp(L), Net::inp(L), Net::outp(L),
                                Net::outp(L), s, [&](int n, int k, float acc) {
        const float dh = rnd<T>(acc);
        const float z = CT<T>::to_f(Zp[n * ldp + k]);
        const float g = rnd<T>(z > 0.0f ? 1.0f : expf(z));
        Zp[n * ldp + k] = CT<T>::from_f(dh * g);
    });
}

// The input gradients of one net from the last layer's dz in s.dzl; every
// layer's dz goes to its scratch rows, for pass 2's weight gradients.
template <typename T, typename Net>
__device__ __noinline__ void net_bwd(const Smem<T>& s, const T* __restrict__ wpad, T* scr,
                                     long row0, int n) {
    using S = Smem<T>;
    store_rows<T>(s.dzl, S::LD, scr + (size_t)scr_dz<Net>(3) * n, DZ3W, row0, n);
    layer_bwd_input<T, Net, 3>(s, s.dzl, S::LD, wpad, s.z3, S::LZ3);
    store_rows<T>(s.z3, S::LZ3, scr + (size_t)scr_dz<Net>(2) * n, Net::H3, row0, n);
    layer_bwd_input<T, Net, 2>(s, s.z3, S::LZ3, wpad, s.z2, S::LZ2);
    store_rows<T>(s.z2, S::LZ2, scr + (size_t)scr_dz<Net>(1) * n, Net::H2, row0, n);
    layer_bwd_input<T, Net, 1>(s, s.z2, S::LZ2, wpad, s.z1, S::LZ1);
    store_rows<T>(s.z1, S::LZ1, scr + (size_t)scr_dz<Net>(0) * n, Net::H1, row0, n);
}

// rows [tile * TN, tile * TN + TN) of obsc into s.x0, zero past n_rows and
// past NCRIT
template <typename T>
__device__ __forceinline__ void load_x0(const Smem<T>& s, const T* __restrict__ obsc, int tile,
                                        int n_rows) {
    constexpr int TN = CT<T>::TN;
    for (int idx = threadIdx.x; idx < TN * X0W; idx += NT) {
        const int n = idx / X0W, c = idx % X0W;
        const long row = (long)tile * TN + n;
        T v = CT<T>::from_f(0.0f);
        if (row < n_rows && c < NCRIT) v = obsc[row * NCRIT + c];
        s.x0[n * Smem<T>::L0 + c] = v;
    }
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

// Row tid's log-prob of its action act[0 .. NACT) under N(s.mu row, exp(logstd));
// fills mu and diff = act - mu.  K3 and K10 both go through this.
template <typename T>
__device__ __forceinline__ float row_logp(const Smem<T>& s, int tid, const float* __restrict__ act,
                                          float* mu, float* diff) {
    float logp = 0.0f;
#pragma unroll
    for (int k = 0; k < NACT; ++k) {
        mu[k] = s.mu[tid * NACT + k];
        diff[k] = act[k] - mu[k];
        logp += -0.5f * diff[k] * diff[k] / s.var[k] - s.logstd[k] - 0.5f * LOG2PI;
    }
    return logp;
}

// ---------------------------------------------------------------------------
// Every launch's first kernel: the weights of `staged` into the zero-padded
// layer layout of wpad (NWPAD values).
template <typename T, typename Net>
__device__ __forceinline__ void pad_net(int i, const T* __restrict__ staged, const int* oW,
                                        T* __restrict__ wpad) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
        const int w0 = Net::wp(l), inp = Net::inp(l);
        if (i >= w0 && i < w0 + Net::outp(l) * inp) {
            const int o = (i - w0) / inp, k = (i - w0) % inp;
            wpad[i] = (o < Net::out(l) && k < Net::in(l)) ? staged[oW[l] + o * Net::in(l) + k]
                                                          : CT<T>::from_f(0.0f);
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(K4_NT) k_pad(const T* __restrict__ staged, Offs offs,
                                              T* __restrict__ wpad) {
    const int i = blockIdx.x * K4_NT + threadIdx.x;
    if (i >= NWPAD) return;
    if (i < ActorNet::end) pad_net<T, ActorNet>(i, staged, offs.aW, wpad);
    else pad_net<T, CriticNet>(i, staged, offs.cW, wpad);
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
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
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
// part_stats[blockIdx.x * NSTAT + slot].
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
    constexpr int TN = CT<T>::TN;
    const int tid = threadIdx.x;
    T* scr = static_cast<T*>(a.scratch);
    for (int i = tid; i < TN * NSTAT; i += NT) s.stat[i] = 0.0f;
    load_logstd<T>(s, a.p, offs.logstd);
    load_bias<T, ActorNet>(s, staged, offs.ab);
    load_bias<T, CriticNet>(s, staged, offs.cb);
    const float mean = ANCHOR ? 0.0f : a.norm[0], rstd = ANCHOR ? 1.0f : a.norm[1];
    const float inv_n = 1.0f / (float)a.n_total;
    const int ntiles = (a.n + TN - 1) / TN;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        __syncthreads();
        load_x0<T>(s, obsc, tile, a.n);
        const long row0 = (long)tile * TN;
        store_rows<T>(s.x0, S::L0, scr, X0W, row0, a.n);
        const long gi = row0 + tid;
        const bool valid = tid < TN && gi < a.n;

        // ---- actor
        net_fwd<T, ActorNet>(s, wpad, s.mu, scr, row0, a.n);
        __syncthreads();
        if (tid < TN) {
            T* dz = s.dzl + tid * S::LD;
            if (valid) {
                float* st = s.stat + tid * NSTAT;
                const float adv = ANCHOR ? a.adv[gi] : (a.adv[gi] - mean) * rstd;
                float diff[NACT], mu[NACT];
                const float logp = row_logp<T>(s, tid, a.act + gi * NACT, mu, diff);
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
        net_bwd<T, ActorNet>(s, wpad, scr, row0, a.n);

        // ---- critic
        net_fwd<T, CriticNet>(s, wpad, s.val, scr, row0, a.n);
        __syncthreads();
        if (tid < TN) {
            T* dz = s.dzl + tid * S::LD;
#pragma unroll
            for (int k = 1; k < DZ3W; ++k) dz[k] = CT<T>::from_f(0.0f);
            float dval = 0.0f;
            if (valid) {
                const float e = s.val[tid] - a.ret[gi];
                dval = 2.0f * e * inv_n;
                if constexpr (ANCHOR) static_cast<T*>(a.val_t)[gi] = CT<T>::from_f(s.val[tid]);
                else s.stat[tid * NSTAT] += e * e;
            }
            dz[0] = CT<T>::from_f(dval);
        }
        net_bwd<T, CriticNet>(s, wpad, scr, row0, a.n);
    }
    bulk_wait();
    __syncthreads();
    if (tid < NSTAT) {
        float sum = 0.0f;
        for (int n = 0; n < TN; ++n) sum += s.stat[n * NSTAT + tid];
        a.part_stats[blockIdx.x * NSTAT + tid] = sum;
    }
}

// K10: the actor forward and the log-prob of rows [0, n) of obsc through K3's
// own device code (net_fwd<ActorNet>, row_logp); mu (f32) and logp out.
template <typename T>
__global__ void __launch_bounds__(NT, 1)
k10_policy_logp(const T* __restrict__ staged, const T* __restrict__ wpad, Offs offs,
                const T* __restrict__ obsc, const float* __restrict__ p,
                const float* __restrict__ act, int n, float* __restrict__ mu_out,
                float* __restrict__ logp_out) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    Smem<T> s(smem_raw);
    constexpr int TN = CT<T>::TN;
    const int tid = threadIdx.x;
    load_logstd<T>(s, p, offs.logstd);
    load_bias<T, ActorNet>(s, staged, offs.ab);
    const int ntiles = (n + TN - 1) / TN;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        __syncthreads();
        load_x0<T>(s, obsc, tile, n);
        net_fwd<T, ActorNet>(s, wpad, s.mu, nullptr, 0, 0);
        __syncthreads();
        const long gi = (long)tile * TN + tid;
        if (tid < TN && gi < n) {
            float diff[NACT], mu[NACT];
            const float logp = row_logp<T>(s, tid, act + gi * NACT, mu, diff);
#pragma unroll
            for (int k = 0; k < NACT; ++k) mu_out[gi * NACT + k] = mu[k];
            logp_out[gi] = logp;
        }
    }
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
static int pad_launch(const void* staged, const Offs& f, void* wpad, cudaStream_t st) {
    k_pad<T><<<(NWPAD + K4_NT - 1) / K4_NT, K4_NT, 0, st>>>((const T*)staged, f, (T*)wpad);
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
    CHECK((cudaError_t)pad_launch<T>(staged, f, wpad, st));
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
    CHECK((cudaError_t)pad_launch<T>(staged, f, wpad, st));
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
    CHECK((cudaError_t)pad_launch<T>(staged, f, wpad, st));
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
    CHECK((cudaError_t)pad_launch<T>(staged, f, wpad, st));
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
    out[1] = NWPAD;
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

// out[N_INFO + 32]: samples per tile of a tile block, padded weight values
// (wpad), scratch values per row, pass-2 tiles, pass-2 rows per step, the
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

// wpad: [NWPAD] of type T scratch; part: [2 * ceil(B / rows per tile) *
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
