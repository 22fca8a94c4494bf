// The fused PPO update for Hopper (sm_90a): K2, K3 and K4, and the rest of
// the reference's FusedUpdate, K8, K9 and K10.
//
//   K2  bg_gae            replaces booster_gym_tpu/algo/update_kernel.py _gae_kernel
//   K3  bg_grads_stats    replaces _grads_stats_kernel (_mlp_fwd_T, _mlp_bwd_T)
//   K4  bg_opt_stage      replaces _opt_stage_kernel
//   K8  bg_values         replaces _values_kernel: K2's value pass on any rows
//   K9  bg_grads          replaces _grads_kernel: K3's tile pass without the
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
// go to the tensor cores through nvcuda::wmma (16 x 16 x 16 bf16 fragments,
// f32 accumulators): a bf16 x bf16 product is exact in f32, so with f32
// accumulation both are the reference's arithmetic up to summation order.
//
// Layouts.  Everything is batch-major.  `obsc` is [rows, NOBS + NPRIV] of
// type T, the actor's observation being its first NOBS columns.  Parameters,
// gradients and Adam moments are flat f32 vectors in the order of the
// PyTorch module's parameters, weights [out, in]; `staged` is the same
// vector in type T.  `offs` gives the 17 offsets into it: actor weights
// (4), actor biases (4), critic weights (4), critic biases (4), logstd.
//
// What bounds them on this card.  K2 and K3 are bound by operations
// (2.3e5 and 1.0e6 flop per sample against 0.1 to 0.4 KB).  A block keeps one
// tile of samples (64 in bf16, 32 in f32) with every layer's activations in
// shared memory, so no activation reaches device memory; weights stream
// through L2 in chunks.  What the tile size costs: every tile stages all the
// weights again and adds a whole gradient (0.71 MB) to the block's partial,
// and those, not the products, take most of K3's time.  K4 is bound by bytes
// (four vectors read, four written).
//
// Sums across blocks are deterministic: each block owns a fixed set of tiles
// and adds them in a fixed order into its own partial, and a second kernel
// adds the partials in block order.  No atomic adds across blocks or
// threads anywhere (see partial_add for the one atomicAdd and its single
// writer).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

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
constexpr int NT = 256;                       // threads per block
constexpr int X0W = ((NCRIT + 31) / 32) * 32; // padded input width
constexpr int DZLW = 32;                      // padded width of the last layer's dz
constexpr int NSTAT = 32;                     // per-sample stat slots (28 used)
constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int HB1 = cmax(AH1, CH1), HB2 = cmax(AH2, CH2), HB3 = cmax(AH3, CH3);
constexpr int WMAX = cmax(cmax(HB1, HB2), cmax(HB3, X0W));
constexpr float LOG2PI = 1.8378770664093453f;

static_assert(NACT <= DZLW, "the action width must fit the last-layer dz buffer");
static_assert(AH1 % 32 == 0 && AH2 % 32 == 0 && AH3 % 32 == 0, "hidden widths: multiples of 32");
static_assert(CH1 % 32 == 0 && CH2 % 32 == 0 && CH3 % 32 == 0, "hidden widths: multiples of 32");
static_assert(4 + 2 * NACT <= NSTAT, "stat slots");

struct Offs { int aW[4], ab[4], cW[4], cb[4], logstd; };

template <typename T> struct CT;
// TN: samples in a tile; KC: rows of a staged weight chunk; PAD: what its
// row stride adds to the width (f32: an odd stride against bank conflicts;
// bf16: wmma wants strides that are multiples of 8 elements)
template <> struct CT<float> {
    static constexpr int TN = 32, KC = 16, PAD = 1;
    static __device__ __forceinline__ float to_f(float x) { return x; }
    static __device__ __forceinline__ float from_f(float x) { return x; }
};
template <> struct CT<__nv_bfloat16> {
    static constexpr int TN = 64, KC = 16, PAD = 8;
    static __device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
    static __device__ __forceinline__ __nv_bfloat16 from_f(float x) { return __float2bfloat16_rn(x); }
};
// x rounded to T, as a float
template <typename T> __device__ __forceinline__ float rnd(float x) {
    return CT<T>::to_f(CT<T>::from_f(x));
}

struct ActorNet {
    static constexpr int D0 = NOBS, H1 = AH1, H2 = AH2, H3 = AH3, DO = NACT;
};
struct CriticNet {
    static constexpr int D0 = NCRIT, H1 = CH1, H2 = CH2, H3 = CH3, DO = 1;
};

// ---------------------------------------------------------------------------
// Shared memory of one block (K2's value pass and K3)
template <typename T> struct Smem {
    static constexpr int TN = CT<T>::TN;
    // a staged chunk is KC rows of up to WMAX (+ PAD), or, for the bf16
    // forward, up to WMAX rows of KC (+ PAD)
    static constexpr size_t n_ws = (size_t)cmax(CT<T>::KC * (WMAX + CT<T>::PAD),
                                                WMAX * (CT<T>::KC + CT<T>::PAD));
    static constexpr size_t n_t = (size_t)TN * (X0W + 2 * HB1 + 2 * HB2 + 2 * HB3 + DZLW) + n_ws;
    static constexpr size_t n_f = (size_t)8 * 256 + (size_t)TN * (NACT + 1 + NSTAT) + 2 * NACT;
    static constexpr size_t bytes = ((n_t * sizeof(T) + 127) / 128) * 128 + n_f * sizeof(float);
    T *x0, *x1, *z1, *x2, *z2, *x3, *z3, *dzl, *ws;
    float *mu, *val, *stat, *logstd, *var, *frag;   // frag: 16 x 16 f32 per warp
    __device__ Smem(unsigned char* raw) {
        T* p = reinterpret_cast<T*>(raw);
        x0 = p; p += TN * X0W;
        x1 = p; p += TN * HB1;
        z1 = p; p += TN * HB1;
        x2 = p; p += TN * HB2;
        z2 = p; p += TN * HB2;
        x3 = p; p += TN * HB3;
        z3 = p; p += TN * HB3;
        dzl = p; p += TN * DZLW;
        ws = p;
        float* f = reinterpret_cast<float*>(raw + ((n_t * sizeof(T) + 127) / 128) * 128);
        frag = f; f += 8 * 256;
        mu = f; f += TN * NACT;
        val = f; f += TN;
        stat = f; f += TN * NSTAT;
        logstd = f; f += NACT;
        var = f;
    }
};
static_assert(Smem<float>::bytes <= 232448, "f32 tile exceeds a block's shared memory");
static_assert(Smem<__nv_bfloat16>::bytes <= 232448, "bf16 tile exceeds a block's shared memory");

// ---------------------------------------------------------------------------
// For every sample n of the tile and every column c < 32 J:
//     epi(n, c, sum_r A[n * lda + r] * B[r][c])
// FWD:  B[r][c] = W[c * IN + r]   (r over inputs, c over outputs: x W^T)
// !FWD: B[r][c] = W[r * IN + c]   (r over outputs, c over inputs: dz W)
// B is staged through shared memory KC values of r at a time, zero outside
// W.  A may hold anything finite in columns past the reduction's end, and
// epi sees columns past B's end (as 0) and must skip them.
// f32: FMAs, a warp takes TN / 8 samples, a lane every 32nd column.
// bf16: wmma; the tile's 16 x 16 fragments are dealt to the 8 warps, and
// each leaves through the warp's f32 scratch to reach epi with coordinates.
template <typename T, int J, bool FWD, typename Epi>
__device__ __forceinline__ void gemm_epi(const T* A, int lda, const T* __restrict__ W, int OUT,
                                         int IN, const Smem<T>& s, Epi epi) {
    constexpr int TN = CT<T>::TN, KC = CT<T>::KC, CW = J * 32;
    constexpr int CP = CW + CT<T>::PAD;     // row stride of a [KC][CW] chunk
    constexpr int KP = KC + CT<T>::PAD;     // row stride of a [CW][KC] chunk
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int R = FWD ? IN : OUT;
    const int C = FWD ? OUT : IN;
    T* Ws = s.ws;
    if constexpr (std::is_same<T, float>::value) {
        constexpr int NS = TN / 8;
        float acc[NS][J];
#pragma unroll
        for (int i = 0; i < NS; ++i)
#pragma unroll
            for (int j = 0; j < J; ++j) acc[i][j] = 0.0f;
        for (int r0 = 0; r0 < R; r0 += KC) {
            __syncthreads();
            for (int idx = tid; idx < CW * KC; idx += NT) {
                int c, rr;
                if (FWD) { c = idx / KC; rr = idx % KC; }
                else     { rr = idx / CW; c = idx % CW; }
                const int r = r0 + rr;
                float v = 0.0f;
                if (c < C && r < R) v = FWD ? W[(size_t)c * IN + r] : W[(size_t)r * IN + c];
                Ws[rr * CP + c] = v;
            }
            __syncthreads();
#pragma unroll 4
            for (int rr = 0; rr < KC; ++rr) {
                float a[NS], b[J];
#pragma unroll
                for (int i = 0; i < NS; ++i) a[i] = A[(warp * NS + i) * lda + r0 + rr];
#pragma unroll
                for (int j = 0; j < J; ++j) b[j] = Ws[rr * CP + lane + 32 * j];
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
        // fragment f = column fragment * NRF + row fragment; warp w owns
        // fragments [w * FPW, (w + 1) * FPW): whole columns of fragments
        // when it has at least NRF of them
        constexpr int NRF = TN / 16, NCF = CW / 16, FPW = NRF * NCF / 8;
        static_assert(NRF * NCF % 8 == 0 && (FPW % NRF == 0 || NRF % FPW == 0), "fragment deal");
        constexpr int NRW = FPW >= NRF ? NRF : FPW;   // row fragments of a warp
        constexpr int NCW = FPW / NRW;                // column fragments of a warp
        const int cf0 = warp * FPW / NRF, rf0 = warp * FPW % NRF;
        using BLayout = typename std::conditional<FWD, wmma::col_major, wmma::row_major>::type;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NCW][NRW];
#pragma unroll
        for (int j = 0; j < NCW; ++j)
#pragma unroll
            for (int i = 0; i < NRW; ++i) wmma::fill_fragment(acc[j][i], 0.0f);
        // FWD keeps W's own orientation, [c][KC] (read as a column-major B),
        // so the copy is straight either way.  A thread fetches its share
        // of the next chunk into registers before the products of the
        // current one, which hides the loads' latency.
        constexpr int PER = CW * KC / NT;
        T pre[PER];
        auto fetch = [&](int r0) {
#pragma unroll
            for (int q = 0; q < PER; ++q) {
                const int idx = tid + q * NT;
                const int c = FWD ? idx / KC : idx % CW;
                const int r = r0 + (FWD ? idx % KC : idx / CW);
                pre[q] = CT<T>::from_f(0.0f);
                if (c < C && r < R) pre[q] = FWD ? W[(size_t)c * IN + r] : W[(size_t)r * IN + c];
            }
        };
        fetch(0);
        for (int r0 = 0; r0 < R; r0 += KC) {
            __syncthreads();
#pragma unroll
            for (int q = 0; q < PER; ++q) {
                const int idx = tid + q * NT;
                Ws[FWD ? (idx / KC) * KP + idx % KC : (idx / CW) * CP + idx % CW] = pre[q];
            }
            __syncthreads();
            if (r0 + KC < R) fetch(r0 + KC);
#pragma unroll
            for (int kk = 0; kk < KC; kk += 16) {
                wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[NRW];
#pragma unroll
                for (int i = 0; i < NRW; ++i)
                    wmma::load_matrix_sync(a[i], A + (rf0 + i) * 16 * lda + r0 + kk, lda);
#pragma unroll
                for (int j = 0; j < NCW; ++j) {
                    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> b;
                    if (FWD) wmma::load_matrix_sync(b, Ws + (cf0 + j) * 16 * KP + kk, KP);
                    else     wmma::load_matrix_sync(b, Ws + kk * CP + (cf0 + j) * 16, CP);
#pragma unroll
                    for (int i = 0; i < NRW; ++i) wmma::mma_sync(acc[j][i], a[i], b, acc[j][i]);
                }
            }
        }
        float* sc = s.frag + warp * 256;
#pragma unroll
        for (int j = 0; j < NCW; ++j)
#pragma unroll
            for (int i = 0; i < NRW; ++i) {
                wmma::store_matrix_sync(sc, acc[j][i], 16, wmma::mem_row_major);
                __syncwarp();
                for (int e = lane; e < 256; e += 32)
                    epi((rf0 + i) * 16 + (e >> 4), (cf0 + j) * 16 + (e & 15), sc[e]);
                __syncwarp();
            }
    }
}

// One dense layer: z = round_T(x W^T) + b in T; hidden layers keep z and
// ELU(z) (both T), the last layer writes z as f32 to outf[n * ldo + o].
template <typename T, int OUT, int IN, bool LAST>
__device__ __forceinline__ void layer_fwd(const Smem<T>& s, const T* X, int ldx,
                                          const T* __restrict__ W, const T* __restrict__ b,
                                          T* Z, T* Xn, float* outf, int ldo) {
    gemm_epi<T, (OUT + 31) / 32, true>(X, ldx, W, OUT, IN, s, [&](int n, int o, float acc) {
        if (o >= OUT) return;
        const float z = rnd<T>(rnd<T>(acc) + CT<T>::to_f(b[o]));
        if (LAST) {
            outf[n * ldo + o] = z;
        } else {
            Z[n * OUT + o] = CT<T>::from_f(z);
            Xn[n * OUT + o] = CT<T>::from_f(z > 0.0f ? z : expf(z) - 1.0f);
        }
    });
}

// (not inlined, like net_bwd: each then gets registers of its own, and the
// one giant function they would make spills)
template <typename T, typename Net>
__device__ __noinline__ void net_fwd(const Smem<T>& s, const T* __restrict__ P,
                                        const int* oW, const int* ob, float* outf) {
    layer_fwd<T, Net::H1, Net::D0, false>(s, s.x0, X0W, P + oW[0], P + ob[0], s.z1, s.x1, nullptr, 0);
    layer_fwd<T, Net::H2, Net::H1, false>(s, s.x1, Net::H1, P + oW[1], P + ob[1], s.z2, s.x2, nullptr, 0);
    layer_fwd<T, Net::H3, Net::H2, false>(s, s.x2, Net::H2, P + oW[2], P + ob[2], s.z3, s.x3, nullptr, 0);
    layer_fwd<T, Net::DO, Net::H3, true>(s, s.x3, Net::H3, P + oW[3], P + ob[3], nullptr, nullptr,
                                         outf, Net::DO);
}

// *p = v on the block's first tile, *p += v after.  p lies in the block's own
// partial and has one writer, this thread, so the additions happen in the
// thread's program order whatever the other blocks do.  The add goes out
// as a reduction that the L2 performs (an atomicAdd whose result is unused):
// the thread does not wait for the old value, which a load-add-store would.
// That, with the prefetch of the weight chunks, took K3 from 8.1 to 4.9 ms
// at 98,304 samples (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py).  Nothing
// here adds across blocks.
__device__ __forceinline__ void partial_add(float* p, float v, bool first) {
    if (first) *p = v;
    else atomicAdd(p, v);
}

// gW[o * IN + k] (+)= sum_n dz[n][o] x[n][k], the tile's samples in order.
// f32: lanes run over k, a warp takes 8 outputs of each 64.  bf16: wmma on
// dz^T (read column-major from DZ) and x, both straight from the tile's
// shared memory; the 16 x 16 fragments of gW are dealt to the warps in runs,
// and a fragment's four dz^T operands are kept while its output row lasts.
template <typename T, int OUT, int IN, int XW>
__device__ __forceinline__ void dw_acc(const Smem<T>& s, const T* DZ, int ldd, const T* XI,
                                       float* __restrict__ gW, bool first) {
    constexpr int TN = CT<T>::TN;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();
    if constexpr (std::is_same<T, float>::value) {
        constexpr int JI = XW / 32;
        for (int ob = 0; ob < OUT; ob += 64) {
            const int o0 = ob + warp * 8;
            if (o0 >= OUT) continue;
            float acc[8][JI];
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < JI; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
            for (int n = 0; n < TN; ++n) {
                float d[8], x[JI];
#pragma unroll
                for (int i = 0; i < 8; ++i) d[i] = DZ[n * ldd + o0 + i];
#pragma unroll
                for (int j = 0; j < JI; ++j) x[j] = XI[n * XW + lane + 32 * j];
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < JI; ++j) acc[i][j] = fmaf(d[i], x[j], acc[i][j]);
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int o = o0 + i;
                if (o < OUT) {
#pragma unroll
                    for (int j = 0; j < JI; ++j) {
                        const int k = lane + 32 * j;
                        if (k < IN) partial_add(gW + (size_t)o * IN + k, acc[i][j], first);
                    }
                }
            }
        }
    } else {
        constexpr int NOF = (OUT + 15) / 16, NKF = XW / 16, NSTEP = TN / 16;
        constexpr int TOTAL = NOF * NKF, PER_WARP = (TOTAL + 7) / 8;
        float* sc = s.frag + warp * 256;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a[NSTEP];
        int cur = -1;
        const int end = (warp + 1) * PER_WARP < TOTAL ? (warp + 1) * PER_WARP : TOTAL;
        for (int f = warp * PER_WARP; f < end; ++f) {
            const int of = f / NKF, kf = f % NKF;
            if (of != cur) {
                cur = of;
#pragma unroll
                for (int t = 0; t < NSTEP; ++t)
                    wmma::load_matrix_sync(a[t], DZ + t * 16 * ldd + of * 16, ldd);
            }
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
            wmma::fill_fragment(acc, 0.0f);
#pragma unroll
            for (int t = 0; t < NSTEP; ++t) {
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
                wmma::load_matrix_sync(b, XI + t * 16 * XW + kf * 16, XW);
                wmma::mma_sync(acc, a[t], b, acc);
            }
            wmma::store_matrix_sync(sc, acc, 16, wmma::mem_row_major);
            __syncwarp();
            for (int e = lane; e < 256; e += 32) {
                const int o = of * 16 + (e >> 4), k = kf * 16 + (e & 15);
                if (o < OUT && k < IN) partial_add(gW + (size_t)o * IN + k, sc[e], first);
            }
            __syncwarp();
        }
    }
}

// gb[o] (+)= sum_n float(dz[n][o]); call after dw_acc's barrier
template <typename T, int OUT>
__device__ __forceinline__ void db_acc(const T* DZ, int ldd, float* __restrict__ gb, bool first) {
    for (int o = threadIdx.x; o < OUT; o += NT) {
        float sum = 0.0f;
        for (int n = 0; n < CT<T>::TN; ++n) sum += CT<T>::to_f(DZ[n * ldd + o]);
        partial_add(gb + o, sum, first);
    }
}

// dz_prev = round_T(dz W) * ELU'(z_prev), written over z_prev
template <typename T, int OUT, int IN>
__device__ __forceinline__ void layer_bwd_input(const Smem<T>& s, const T* DZ, int ldd,
                                                const T* __restrict__ W, T* Zp) {
    gemm_epi<T, IN / 32, false>(DZ, ldd, W, OUT, IN, s, [&](int n, int k, float acc) {
        const float dh = rnd<T>(acc);
        const float z = CT<T>::to_f(Zp[n * IN + k]);
        const float g = rnd<T>(z > 0.0f ? 1.0f : expf(z));
        Zp[n * IN + k] = CT<T>::from_f(dh * g);
    });
}

// Backward through one net from the last layer's dz in s.dzl; adds this
// tile's weight and bias gradients into the block's partial G.
template <typename T, typename Net>
__device__ __noinline__ void net_bwd(const Smem<T>& s, const T* __restrict__ P, float* G,
                                        const int* oW, const int* ob, bool first) {
    dw_acc<T, Net::DO, Net::H3, Net::H3>(s, s.dzl, DZLW, s.x3, G + oW[3], first);
    db_acc<T, Net::DO>(s.dzl, DZLW, G + ob[3], first);
    layer_bwd_input<T, Net::DO, Net::H3>(s, s.dzl, DZLW, P + oW[3], s.z3);

    dw_acc<T, Net::H3, Net::H2, Net::H2>(s, s.z3, Net::H3, s.x2, G + oW[2], first);
    db_acc<T, Net::H3>(s.z3, Net::H3, G + ob[2], first);
    layer_bwd_input<T, Net::H3, Net::H2>(s, s.z3, Net::H3, P + oW[2], s.z2);

    dw_acc<T, Net::H2, Net::H1, Net::H1>(s, s.z2, Net::H2, s.x1, G + oW[1], first);
    db_acc<T, Net::H2>(s.z2, Net::H2, G + ob[1], first);
    layer_bwd_input<T, Net::H2, Net::H1>(s, s.z2, Net::H2, P + oW[1], s.z1);

    dw_acc<T, Net::H1, Net::D0, X0W>(s, s.z1, Net::H1, s.x0, G + oW[0], first);
    db_acc<T, Net::H1>(s.z1, Net::H1, G + ob[0], first);
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
        s.x0[idx] = v;
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
// K2, kernel 1 of 2: critic values of every row of obsc (T + 1 planes).  K8
// launches the same kernel on any [n_rows, NCRIT] plane.
template <typename T>
__global__ void __launch_bounds__(NT, 1)
k2_values(const T* __restrict__ staged, Offs offs, const T* __restrict__ obsc, int n_rows,
          float* __restrict__ values) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    Smem<T> s(smem_raw);
    constexpr int TN = CT<T>::TN;
    const int ntiles = (n_rows + TN - 1) / TN;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        __syncthreads();
        load_x0<T>(s, obsc, tile, n_rows);
        net_fwd<T, CriticNet>(s, staged, offs.cW, offs.cb, s.val);
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
// K3, kernel 1 of 2.  A persistent block walks tiles blockIdx.x, + gridDim.x,
// ...: actor forward, the per-sample loss gradient, actor backward, then the
// same for the critic.  Weight gradients go to the block's partial
// part[blockIdx.x * stride + flat index]; the per-sample sums (value loss,
// actor loss, both bound-loss halves, sum (mu - mu_old)^2 per action,
// dlogstd per action) to part_stats[blockIdx.x * NSTAT + slot].
//
// ANCHOR makes it K9: the advantages are used as given (no mean, rstd),
// the old policy is always old_logp, the loss means divide by n_total while
// the mask keeps the local row count n, no metric sum is formed (only the
// dlogstd slots), and each valid row's mu and value leave in type T
// through mu_t and val_t in place of mu_out and logp_out.
struct K3Args {
    const float *p, *act, *mu_old, *old_logp, *adv, *ret, *norm;
    float *part, *part_stats, *mu_out, *logp_out;
    void *mu_t, *val_t;
    int self_old, n, n_total, stride;
    float lo, hi, bscale;
};

template <typename T, bool ANCHOR>
__global__ void __launch_bounds__(NT, 1)
k3_grads_stats(const T* __restrict__ staged, Offs offs, const T* __restrict__ obsc, K3Args a) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    Smem<T> s(smem_raw);
    constexpr int TN = CT<T>::TN;
    const int tid = threadIdx.x;
    for (int i = tid; i < TN * DZLW; i += NT) s.dzl[i] = CT<T>::from_f(0.0f);
    for (int i = tid; i < TN * NSTAT; i += NT) s.stat[i] = 0.0f;
    load_logstd<T>(s, a.p, offs.logstd);
    const float mean = ANCHOR ? 0.0f : a.norm[0], rstd = ANCHOR ? 1.0f : a.norm[1];
    const float inv_n = 1.0f / (float)(ANCHOR ? a.n_total : a.n);
    float* G = a.part + (size_t)blockIdx.x * a.stride;
    const int ntiles = (a.n + TN - 1) / TN;
    bool first = true;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, first = false) {
        __syncthreads();
        load_x0<T>(s, obsc, tile, a.n);
        const long gi = (long)tile * TN + tid;
        const bool valid = tid < TN && gi < a.n;

        // ---- actor
        net_fwd<T, ActorNet>(s, staged, offs.aW, offs.ab, s.mu);
        __syncthreads();
        if (tid < TN) {
            T* dz = s.dzl + tid * DZLW;
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
                if constexpr (!ANCHOR) {
                    st[1] += fmaxf(surr, surr_c);
                    a.logp_out[gi] = logp;
                }
            } else {
#pragma unroll
                for (int k = 0; k < NACT; ++k) dz[k] = CT<T>::from_f(0.0f);
            }
        }
        net_bwd<T, ActorNet>(s, staged, G, offs.aW, offs.ab, first);

        // ---- critic
        net_fwd<T, CriticNet>(s, staged, offs.cW, offs.cb, s.val);
        __syncthreads();
        if (tid < TN) {
            T* dz = s.dzl + tid * DZLW;
#pragma unroll
            for (int k = 1; k < NACT; ++k) dz[k] = CT<T>::from_f(0.0f);
            float dval = 0.0f;
            if (valid) {
                const float e = s.val[tid] - a.ret[gi];
                dval = 2.0f * e * inv_n;
                if constexpr (ANCHOR) static_cast<T*>(a.val_t)[gi] = CT<T>::from_f(s.val[tid]);
                else s.stat[tid * NSTAT] += e * e;
            }
            dz[0] = CT<T>::from_f(dval);
        }
        net_bwd<T, CriticNet>(s, staged, G, offs.cW, offs.cb, first);
    }
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
k10_policy_logp(const T* __restrict__ staged, Offs offs, const T* __restrict__ obsc,
                const float* __restrict__ p, const float* __restrict__ act, int n,
                float* __restrict__ mu_out, float* __restrict__ logp_out) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    Smem<T> s(smem_raw);
    constexpr int TN = CT<T>::TN;
    const int tid = threadIdx.x;
    load_logstd<T>(s, p, offs.logstd);
    const int ntiles = (n + TN - 1) / TN;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        __syncthreads();
        load_x0<T>(s, obsc, tile, n);
        net_fwd<T, ActorNet>(s, staged, offs.aW, offs.ab, s.mu);
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

// K3, kernel 2 of 2: add the blocks' partials in block order into the flat
// gradient g (dlogstd from the stat partials) and the 4 + NACT metric sums.
__global__ void k3_reduce(const float* __restrict__ part, const float* __restrict__ part_stats,
                          int nblk, int stride, int n_params, int logstd_off,
                          float* __restrict__ g, float* __restrict__ stats) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n_params) {
        float sum = 0.0f;
        if (i >= logstd_off && i < logstd_off + NACT) {
            for (int b = 0; b < nblk; ++b) sum += part_stats[b * NSTAT + 4 + NACT + (i - logstd_off)];
        } else {
            for (int b = 0; b < nblk; ++b) sum += part[(size_t)b * stride + i];
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

__global__ void __launch_bounds__(NT)
k4_sumsq(const float* __restrict__ g, int n, int logstd_off, float entropy_coef,
         float* __restrict__ part) {
    __shared__ float sm[NT];
    const int chunk = (n + K4_BLOCKS - 1) / K4_BLOCKS;
    const int lo = blockIdx.x * chunk, hi = lo + chunk < n ? lo + chunk : n;
    float sum = 0.0f;
    for (int i = lo + threadIdx.x; i < hi; i += NT) {
        const float x = k4_grad(g, i, logstd_off, entropy_coef);
        sum += x * x;
    }
    sm[threadIdx.x] = sum;
    __syncthreads();
    for (int w = NT / 2; w > 0; w >>= 1) {
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
__global__ void __launch_bounds__(NT) k4_adam(K4Args a, T* __restrict__ staged) {
    const int i = blockIdx.x * NT + threadIdx.x;
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

template <typename T>
static int gae_launch(const void* staged, const int* offs, const void* obsc, const float* rew,
                      const float* nonterm, const float* timeout, float* values, float* adv,
                      float* ret, float* sums, int T_, int B, float gamma, float lam, int nblk,
                      void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err = cudaFuncSetAttribute(k2_values<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)Smem<T>::bytes);
    if (err != cudaSuccess) return (int)err;
    const int n_rows = (T_ + 1) * B;
    const int ntiles = (n_rows + CT<T>::TN - 1) / CT<T>::TN;
    k2_values<T><<<(nblk < ntiles ? nblk : ntiles), NT, Smem<T>::bytes, st>>>(
        (const T*)staged, make_offs(offs), (const T*)obsc, n_rows, values);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    k2_scan<<<1, 1024, 0, st>>>(values, rew, nonterm, timeout, adv, ret, sums, T_, B, gamma, lam);
    return (int)cudaGetLastError();
}

template <typename T>
static int values_launch(const void* staged, const int* offs, const void* obsc, int n_rows,
                         float* values, int nblk, void* stream) {
    cudaError_t err = cudaFuncSetAttribute(k2_values<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)Smem<T>::bytes);
    if (err != cudaSuccess) return (int)err;
    k2_values<T><<<nblk, NT, Smem<T>::bytes, (cudaStream_t)stream>>>(
        (const T*)staged, make_offs(offs), (const T*)obsc, n_rows, values);
    return (int)cudaGetLastError();
}

template <typename T, bool ANCHOR>
static int grads_stats_launch(const void* staged, const int* offs, const void* obsc, K3Args a,
                              int n_params, float* g, float* stats, int nblk, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err = cudaFuncSetAttribute(k3_grads_stats<T, ANCHOR>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)Smem<T>::bytes);
    if (err != cudaSuccess) return (int)err;
    const Offs f = make_offs(offs);
    k3_grads_stats<T, ANCHOR><<<nblk, NT, Smem<T>::bytes, st>>>((const T*)staged, f,
                                                               (const T*)obsc, a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    k3_reduce<<<(n_params + NT - 1) / NT, NT, 0, st>>>(a.part, a.part_stats, nblk, a.stride,
                                                      n_params, f.logstd, g, stats);
    return (int)cudaGetLastError();
}

template <typename T>
static int policy_logp_launch(const void* staged, const int* offs, const void* obsc,
                              const float* p, const float* act, int n, float* mu, float* logp,
                              int nblk, void* stream) {
    cudaError_t err = cudaFuncSetAttribute(k10_policy_logp<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)Smem<T>::bytes);
    if (err != cudaSuccess) return (int)err;
    k10_policy_logp<T><<<nblk, NT, Smem<T>::bytes, (cudaStream_t)stream>>>(
        (const T*)staged, make_offs(offs), (const T*)obsc, p, act, n, mu, logp);
    return (int)cudaGetLastError();
}

template <typename T>
static int opt_stage_launch(K4Args a, float* part, void* staged, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    k4_sumsq<<<K4_BLOCKS, NT, 0, st>>>(a.g, a.n, a.logstd_off, a.entropy_coef, part);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    a.part = part;
    k4_adam<T><<<(a.n + NT - 1) / NT, NT, 0, st>>>(a, (T*)staged);
    return (int)cudaGetLastError();
}

extern "C" {

// the number of samples a block holds at once, for the wrapper's grid
int bg_update_tile(int bf16) { return bf16 ? CT<__nv_bfloat16>::TN : CT<float>::TN; }

int bg_gae(int bf16, const void* staged, const int* offs, const void* obsc, const float* rew,
           const float* nonterm, const float* timeout, float* values, float* adv, float* ret,
           float* sums, int T_, int B, float gamma, float lam, int nblk, void* stream) {
    return bf16 ? gae_launch<__nv_bfloat16>(staged, offs, obsc, rew, nonterm, timeout, values, adv,
                                            ret, sums, T_, B, gamma, lam, nblk, stream)
                : gae_launch<float>(staged, offs, obsc, rew, nonterm, timeout, values, adv, ret,
                                    sums, T_, B, gamma, lam, nblk, stream);
}

// part: [nblk * stride] f32, part_stats: [nblk * 32] f32 scratch
int bg_grads_stats(int bf16, const void* staged, const float* p, const int* offs, const void* obsc,
                   const float* act, const float* mu_old, const float* old_logp, const float* adv,
                   const float* ret, const float* norm, int self_old, int n, float lo, float hi,
                   float bscale, float* part, float* part_stats, int stride, int n_params,
                   float* g, float* stats, float* mu_out, float* logp_out, int nblk,
                   void* stream) {
    K3Args a;
    a.p = p; a.act = act; a.mu_old = mu_old; a.old_logp = old_logp; a.adv = adv; a.ret = ret;
    a.norm = norm; a.part = part; a.part_stats = part_stats; a.mu_out = mu_out;
    a.logp_out = logp_out; a.mu_t = nullptr; a.val_t = nullptr; a.self_old = self_old; a.n = n;
    a.n_total = n; a.stride = stride; a.lo = lo; a.hi = hi; a.bscale = bscale;
    return bf16 ? grads_stats_launch<__nv_bfloat16, false>(staged, offs, obsc, a, n_params, g,
                                                           stats, nblk, stream)
                : grads_stats_launch<float, false>(staged, offs, obsc, a, n_params, g, stats,
                                                   nblk, stream);
}

// K8: critic values of rows [0, n_rows) of obsc
int bg_values(int bf16, const void* staged, const int* offs, const void* obsc, int n_rows,
              float* values, int nblk, void* stream) {
    return bf16 ? values_launch<__nv_bfloat16>(staged, offs, obsc, n_rows, values, nblk, stream)
                : values_launch<float>(staged, offs, obsc, n_rows, values, nblk, stream);
}

// K9: part and part_stats as for bg_grads_stats; stats: [4 + NACT] f32
// scratch, which the reduce fills with zeros (K9 forms no metric sums);
// mu_t [n, NACT] and val_t [n] in type T
int bg_grads(int bf16, const void* staged, const float* p, const int* offs, const void* obsc,
             const float* act, const float* old_logp, const float* adv, const float* ret, int n,
             int n_total, float lo, float hi, float bscale, float* part, float* part_stats,
             int stride, int n_params, float* g, float* stats, void* mu_t, void* val_t, int nblk,
             void* stream) {
    K3Args a;
    a.p = p; a.act = act; a.mu_old = nullptr; a.old_logp = old_logp; a.adv = adv; a.ret = ret;
    a.norm = nullptr; a.part = part; a.part_stats = part_stats; a.mu_out = nullptr;
    a.logp_out = nullptr; a.mu_t = mu_t; a.val_t = val_t; a.self_old = 0; a.n = n;
    a.n_total = n_total; a.stride = stride; a.lo = lo; a.hi = hi; a.bscale = bscale;
    return bf16 ? grads_stats_launch<__nv_bfloat16, true>(staged, offs, obsc, a, n_params, g,
                                                          stats, nblk, stream)
                : grads_stats_launch<float, true>(staged, offs, obsc, a, n_params, g, stats,
                                                  nblk, stream);
}

// K10: mu [n, NACT] and logp [n] f32 of rows [0, n) of obsc and act
int bg_policy_logp(int bf16, const void* staged, const float* p, const int* offs,
                   const void* obsc, const float* act, int n, float* mu, float* logp, int nblk,
                   void* stream) {
    return bf16 ? policy_logp_launch<__nv_bfloat16>(staged, offs, obsc, p, act, n, mu, logp,
                                                    nblk, stream)
                : policy_logp_launch<float>(staged, offs, obsc, p, act, n, mu, logp, nblk,
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
