// The fused PPO update for Hopper (sm_90a): K2, K3 and K4, and the rest of
// the reference's FusedUpdate, K8, K9 and K10.
//
//   K2  bg_gae            replaces booster_gym_tpu/algo/update_kernel.py _gae_kernel
//   K3  bg_grads_stats    replaces _grads_stats_kernel (_mlp_fwd_T, _mlp_bwd_T)
//   K4  bg_opt_stage      replaces _opt_stage_kernel
//   K8  bg_values         replaces _values_kernel: K2's value pass on any rows
//   K9  bg_grads          replaces _grads_kernel: K3's passes without the
//                         metric sums and the normalisation, n_total apart
//                         from the row count, mu and values out in type T
//   K10 bg_policy_logp    replaces _policy_logp_kernel: K3's actor forward and
//                         log-prob, through the same device code
//
// K8-K10 share K2's and K3's device code (net_fwd, net_bwd, the log-prob),
// so their bounds and their gaps to them are K2's and K3's: K8 and K10 are
// bound by operations like K2 (the critic's 2.3e5, the actor's 1.3e5 flop
// per row), K9 like K3.
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
// (2.3e5 and 1.0e6 flop per sample against 0.1 to 0.4 KB).  A tile block (16
// warps, one per SM) keeps one tile of samples (64 in bf16, 32 in f32) with
// every layer's activations in shared memory; weights stream through L2 in
// chunks of 32 (bf16) or 16 (f32) reduction rows, double-buffered with
// cp.async, one block barrier per chunk.  K3 (and K9) is three passes, all
// on the caller's stream:
//   pass 1 (k3_pass1)  per tile: forward, the per-row loss step, the input
//                      gradients of both nets; every layer's input x_l and
//                      output gradient dz_l leave as rows in type T, by bulk
//                      copies that run on while the block computes, to a
//                      scratch in device memory (2,400 values per row), and
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
// K4 is bound by bytes (four vectors read, four written).
//
// Sums across blocks are deterministic: each pass-1 block owns a fixed set
// of tiles and adds their stats in a fixed order into its own partial, each
// pass-2 block owns one tile of one slab, and the reduce adds the partials in
// block or slab order.  No atomic adds anywhere.

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

constexpr int NCRIT = NOBS + NPRIV;
constexpr int NT = 512;                       // threads of a tile block (one per SM)
constexpr int NW = NT / 32;                   // its warps
constexpr int K4_NT = 256;                    // threads of K4's blocks and the reduce
constexpr int X0W = ((NCRIT + 31) / 32) * 32; // padded input width
constexpr int DZ3W = 16;                      // padded width of the last layer's dz
constexpr int NSTAT = 32;                     // per-sample stat slots (28 used)
// (host and device: the kernels call them with run-time arguments too)
#define HD __host__ __device__
constexpr HD int cmax(int a, int b) { return a > b ? a : b; }
constexpr HD int rup(int x, int m) { return (x + m - 1) / m * m; }
constexpr int HB1 = cmax(AH1, CH1), HB2 = cmax(AH2, CH2), HB3 = cmax(AH3, CH3);
constexpr int HBA = cmax(HB1, HB3);           // the x buffer of layers 1 and 3
constexpr float LOG2PI = 1.8378770664093453f;

static_assert(NACT <= DZ3W, "the action width must fit the last-layer dz rows");
static_assert(AH1 % 32 == 0 && AH2 % 32 == 0 && AH3 % 32 == 0, "hidden widths: multiples of 32");
static_assert(CH1 % 32 == 0 && CH2 % 32 == 0 && CH3 % 32 == 0, "hidden widths: multiples of 32");
static_assert(HB1 <= 256 && HB2 <= 256 && HB3 <= 256, "hidden widths: at most 256");
static_assert(4 + 2 * NACT <= NSTAT, "stat slots");

struct Offs { int aW[4], ab[4], cW[4], cb[4], logstd; };

template <typename T> struct CT;
// TN: samples in a tile; KC: reduction rows of a staged weight chunk, ST of
// them in flight (more stages and shorter chunks measured slower on the
// H100); PAD: what a shared-memory row stride adds to its width (multiples
// of 16 bytes, and for bf16 an odd number of 16-byte units, so the 8 rows an
// ldmatrix reads fall in different banks); VEC: values in 16 bytes
template <> struct CT<float> {
    static constexpr int TN = 32, KC = 16, ST = 2, PAD = 4, VEC = 4;
    static __device__ __forceinline__ float to_f(float x) { return x; }
    static __device__ __forceinline__ float from_f(float x) { return x; }
};
template <> struct CT<__nv_bfloat16> {
    static constexpr int TN = 64, KC = 32, ST = 2, PAD = 8, VEC = 8;   // KC 32: swz
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
// every layer's bias, in a tile block's shared memory: the actor's four,
// then the critic's
constexpr int NB_ACTOR = AH1 + AH2 + AH3 + NACT, NBIAS = NB_ACTOR + CH1 + CH2 + CH3 + 1;
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
// Shared memory of a tile block (K2's value pass, K3's pass 1, K10).  Row
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
static_assert(Smem<float>::bytes <= 232448, "f32 tile exceeds a block's shared memory");
static_assert(Smem<__nv_bfloat16>::bytes <= 232448, "bf16 tile exceeds a block's shared memory");
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
// K2, kernel 1 of 2: critic values of every row of obsc (T + 1 planes).  K8
// launches the same kernel on any [n_rows, NCRIT] plane.
template <typename T>
__global__ void __launch_bounds__(NT, 1)
k2_values(const T* __restrict__ staged, const T* __restrict__ wpad, Offs offs,
          const T* __restrict__ obsc, int n_rows, float* __restrict__ values) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    Smem<T> s(smem_raw);
    constexpr int TN = CT<T>::TN;
    const int ntiles = (n_rows + TN - 1) / TN;
    load_bias<T, CriticNet>(s, staged, offs.cb);
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        __syncthreads();
        load_x0<T>(s, obsc, tile, n_rows);
        net_fwd<T, CriticNet>(s, wpad, s.val, nullptr, 0, 0);
        __syncthreads();
        const long row = (long)tile * TN + threadIdx.x;
        if (threadIdx.x < TN && row < n_rows) values[row] = s.val[threadIdx.x];
    }
}

// K2, kernel 2 of 2: timeout bootstrap, the GAE recurrence backwards in time
// for each env, returns, and sum(adv), sum(adv^2).  One block: a thread
// walks its envs, then a fixed-order tree adds the threads' sums.
__global__ void __launch_bounds__(1024, 1)
k2_scan(const float* __restrict__ values, const float* __restrict__ rew,
        const float* __restrict__ nonterm, const float* __restrict__ timeout,
        float* __restrict__ adv, float* __restrict__ ret, float* __restrict__ sums,
        int T, int B, float gamma, float lam) {
    __shared__ float s1[1024], s2[1024];
    float sa = 0.0f, sa2 = 0.0f;
    for (int b = threadIdx.x; b < B; b += 1024) {
        float nextv = values[(size_t)T * B + b];
        float carry = 0.0f;
        for (int t = T - 1; t >= 0; --t) {
            const size_t i = (size_t)t * B + b;
            const float v = values[i], tf = timeout[i], nt = nonterm[i];
            const float rwd = tf * v + (1.0f - tf) * rew[i];
            const float delta = rwd + gamma * nt * nextv - v;
            const float a = delta + gamma * lam * nt * carry;
            carry = a;
            nextv = v;
            adv[i] = a;
            ret[i] = v + a;
            sa += a;
            sa2 += a * a;
        }
    }
    s1[threadIdx.x] = sa;
    s2[threadIdx.x] = sa2;
    __syncthreads();
    for (int w = 512; w > 0; w >>= 1) {
        if (threadIdx.x < w) {
            s1[threadIdx.x] += s1[threadIdx.x + w];
            s2[threadIdx.x] += s2[threadIdx.x + w];
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) { sums[0] = s1[0]; sums[1] = s2[0]; }
}

// ---------------------------------------------------------------------------
// K3, pass 1.  A persistent block walks tiles blockIdx.x, + gridDim.x, ...:
// actor forward, the per-sample loss gradient, actor input gradients, then
// the same for the critic; x_l and dz_l of every layer go to the scratch
// (see ScratchOf), the per-sample sums (value loss, actor loss, both
// bound-loss halves, sum (mu - mu_old)^2 per action, dlogstd per action) to
// part_stats[blockIdx.x * NSTAT + slot].
//
// ANCHOR makes it K9: the advantages are used as given (no mean, rstd),
// the old policy is always old_logp, the loss means divide by n_total while
// the mask keeps the local row count n, no metric sum is formed (only the
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
    const float inv_n = 1.0f / (float)(ANCHOR ? a.n_total : a.n);
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
// K4, kernel 1 of 2: per-block sums of squares of the gradient (entropy
// coefficient added on logstd first), fixed order inside the block.
constexpr int K4_BLOCKS = 64;

__device__ __forceinline__ float k4_grad(const float* __restrict__ g, int i, int logstd_off,
                                         float entropy_coef) {
    float x = g[i];
    if (i >= logstd_off && i < logstd_off + NACT) x += entropy_coef;
    return x;
}

__global__ void __launch_bounds__(K4_NT)
k4_sumsq(const float* __restrict__ g, int n, int logstd_off, float entropy_coef,
         float* __restrict__ part) {
    __shared__ float sm[K4_NT];
    const int chunk = (n + K4_BLOCKS - 1) / K4_BLOCKS;
    const int lo = blockIdx.x * chunk, hi = lo + chunk < n ? lo + chunk : n;
    float sum = 0.0f;
    for (int i = lo + threadIdx.x; i < hi; i += K4_NT) {
        const float x = k4_grad(g, i, logstd_off, entropy_coef);
        sum += x * x;
    }
    sm[threadIdx.x] = sum;
    __syncthreads();
    for (int w = K4_NT / 2; w > 0; w >>= 1) {
        if (threadIdx.x < w) sm[threadIdx.x] += sm[threadIdx.x + w];
        __syncthreads();
    }
    if (threadIdx.x == 0) part[blockIdx.x] = sm[0];
}

// K4, kernel 2 of 2: every thread adds the same partials in the same order,
// so all see one norm; then clip, Adam, and the copy of the new parameters
// in type T.  lr is read from device memory.
struct K4Args {
    const float *g, *p, *m, *v, *lr, *part;
    float *p2, *m2, *v2;
    int n, cnt, logstd_off;
    float entropy_coef, b1, omb1, b2, omb2, logb1, logb2, eps, max_norm;
};

template <typename T>
__global__ void __launch_bounds__(K4_NT) k4_adam(K4Args a, T* __restrict__ staged) {
    const int i = blockIdx.x * K4_NT + threadIdx.x;
    if (i >= a.n) return;
    float sq = 0.0f;
    for (int b = 0; b < K4_BLOCKS; ++b) sq += a.part[b];
    const float g_norm = sqrtf(sq);
    const float scale = g_norm < a.max_norm ? 1.0f : a.max_norm / g_norm;
    const float cnt2 = (float)(a.cnt + 1);
    const float bc1 = 1.0f - expf(cnt2 * a.logb1);
    const float bc2 = 1.0f - expf(cnt2 * a.logb2);
    const float g = k4_grad(a.g, i, a.logstd_off, a.entropy_coef) * scale;
    const float m2 = a.b1 * a.m[i] + a.omb1 * g;
    const float v2 = a.b2 * a.v[i] + a.omb2 * (g * g);
    const float upd = (-a.lr[0]) * ((m2 / bc1) / (sqrtf(v2 / bc2) + a.eps));
    const float p2 = a.p[i] + upd;
    a.p2[i] = p2;
    a.m2[i] = m2;
    a.v2[i] = v2;
    staged[i] = CT<T>::from_f(p2);
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

template <typename T>
static int gae_launch(const void* staged, const int* offs, void* wpad, const void* obsc,
                      const float* rew, const float* nonterm, const float* timeout, float* values,
                      float* adv, float* ret, float* sums, int T_, int B, float gamma, float lam,
                      int nblk, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const Offs f = make_offs(offs);
    CHECK((cudaError_t)allow_smem(k2_values<T>, Smem<T>::bytes));
    CHECK((cudaError_t)pad_launch<T>(staged, f, wpad, st));
    const int n_rows = (T_ + 1) * B;
    const int ntiles = (n_rows + CT<T>::TN - 1) / CT<T>::TN;
    k2_values<T><<<(nblk < ntiles ? nblk : ntiles), NT, Smem<T>::bytes, st>>>(
        (const T*)staged, (const T*)wpad, f, (const T*)obsc, n_rows, values);
    CHECK(cudaGetLastError());
    k2_scan<<<1, 1024, 0, st>>>(values, rew, nonterm, timeout, adv, ret, sums, T_, B, gamma, lam);
    return (int)cudaGetLastError();
}

template <typename T>
static int values_launch(const void* staged, const int* offs, void* wpad, const void* obsc,
                         int n_rows, float* values, int nblk, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const Offs f = make_offs(offs);
    CHECK((cudaError_t)allow_smem(k2_values<T>, Smem<T>::bytes));
    CHECK((cudaError_t)pad_launch<T>(staged, f, wpad, st));
    k2_values<T><<<nblk, NT, Smem<T>::bytes, st>>>((const T*)staged, (const T*)wpad, f,
                                                   (const T*)obsc, n_rows, values);
    return (int)cudaGetLastError();
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

template <typename T>
static int opt_stage_launch(K4Args a, float* part, void* staged, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    k4_sumsq<<<K4_BLOCKS, K4_NT, 0, st>>>(a.g, a.n, a.logstd_off, a.entropy_coef, part);
    CHECK(cudaGetLastError());
    a.part = part;
    k4_adam<T><<<(a.n + K4_NT - 1) / K4_NT, K4_NT, 0, st>>>(a, (T*)staged);
    return (int)cudaGetLastError();
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

template <typename T>
static int info(int* out) {
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
    scratch_layout<ActorNet>(out + 9);
    scratch_layout<CriticNet>(out + 25);
    return 0;
}

extern "C" {

// out[41]: samples per tile of a tile block, padded weight values (wpad),
// scratch values per row, pass-2 tiles, pass-2 rows per step, the shared
// memory of a tile block and of a pass-2 block, K3's pass-1 and pass-2
// resident blocks per SM, then the scratch layout of the actor's four
// layers and the critic's (x offset, x width, dz offset, dz width each)
int bg_update_info(int bf16, int* out) {
    return bf16 ? info<__nv_bfloat16>(out) : info<float>(out);
}

// wpad: [NWPAD] of type T scratch
int bg_gae(int bf16, const void* staged, const int* offs, void* wpad, const void* obsc,
           const float* rew, const float* nonterm, const float* timeout, float* values, float* adv,
           float* ret, float* sums, int T_, int B, float gamma, float lam, int nblk, void* stream) {
    return bf16 ? gae_launch<__nv_bfloat16>(staged, offs, wpad, obsc, rew, nonterm, timeout, values,
                                            adv, ret, sums, T_, B, gamma, lam, nblk, stream)
                : gae_launch<float>(staged, offs, wpad, obsc, rew, nonterm, timeout, values, adv,
                                    ret, sums, T_, B, gamma, lam, nblk, stream);
}

// wpad as for bg_gae; scratch: [n * SCR_WIDTH] of type T; part: [nslab *
// stride] f32, part_stats: [nblk * 32] f32 scratch; slab s holds rows
// [s * slab_rows, min((s + 1) * slab_rows, n)); ev: null, or four CUDA
// events that time the passes (grads_stats_launch)
int bg_grads_stats(int bf16, const void* staged, const float* p, const int* offs, void* wpad,
                   const void* obsc, const float* act, const float* mu_old, const float* old_logp,
                   const float* adv, const float* ret, const float* norm, int self_old, int n,
                   float lo, float hi, float bscale, void* scratch, float* part, float* part_stats,
                   int stride, int nslab, int slab_rows, int n_params, float* g, float* stats,
                   float* mu_out, float* logp_out, int nblk, void* const* ev, void* stream) {
    K3Args a;
    a.p = p; a.act = act; a.mu_old = mu_old; a.old_logp = old_logp; a.adv = adv; a.ret = ret;
    a.norm = norm; a.part = part; a.part_stats = part_stats; a.mu_out = mu_out;
    a.logp_out = logp_out; a.mu_t = nullptr; a.val_t = nullptr; a.scratch = scratch;
    a.self_old = self_old; a.n = n; a.n_total = n; a.stride = stride; a.nslab = nslab;
    a.slab_rows = slab_rows; a.lo = lo; a.hi = hi; a.bscale = bscale;
    return bf16 ? grads_stats_launch<__nv_bfloat16, false>(staged, offs, wpad, obsc, a, n_params,
                                                           g, stats, nblk, ev, stream)
                : grads_stats_launch<float, false>(staged, offs, wpad, obsc, a, n_params, g,
                                                   stats, nblk, ev, stream);
}

// K8: critic values of rows [0, n_rows) of obsc
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

// part: [64] f32 scratch
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
    return bf16 ? opt_stage_launch<__nv_bfloat16>(a, part, staged, stream)
                : opt_stage_launch<float>(a, part, staged, stream);
}

}  // extern "C"
