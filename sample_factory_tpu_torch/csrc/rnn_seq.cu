// GRU and LSTM recurrences over one BPTT segment, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of sample_factory_tpu/ops/pallas_gru.py:
//   gru_seq_forward  <- _gru_kernel  (:78-109, pallas_call at :148)
//   lstm_seq_forward <- _lstm_kernel (:226-253, pallas_call at :271)
//
// What is computed (the input projection of all T steps is done beforehand by one matmul):
//   GRU : h_proj = T(h @ wh, f32 accumulation) + bh; r = s(xr + hr); z = s(xz + hz);
//         n = tanh(xn + r * hn); h' = (1 - z) * n + z * h; out[t] = h'; carry = reset ? 0 : h'
//   LSTM: proj = x + T(h @ wh); c' = s(f + 1) * c + s(i) * tanh(g); h' = s(o) * tanh(c');
//         out[t] = h'; carry [h', c'] = reset ? 0 : [h', c']
// with s(x) = 1 / (1 + exp(-x)). T is the input type (float or bf16). Every gate operation
// is computed in f32 from T operands and rounded to T, as PyTorch's elementwise ops on T
// tensors do; only the matmul accumulation and the carried state are f32.
//
// Bound on the H100: at the main-path shape (T=32, B=512, H=256, bf16) the function must
// move ~43 MB (x_proj, outs, states, wh) against ~6.4 GFLOP, so HBM bandwidth bounds it
// (~13 us at 3.35 TB/s). What a step costs in practice is latency: 32 dependent steps,
// each a small product followed by an exchange of the new carry.
//
// Design "cluster" (seq_cluster_kernel). The TPU kernel keeps all of wh in VMEM; on Hopper
// bf16 wh is 384 KB at H=256 against 227 KB of shared memory per block. So wh is split by
// columns across the C blocks of a thread-block cluster (C = 8, or 16 where a slice of 8
// does not fit), and the cluster owns a tile of BT batch rows:
//   - block r owns hidden units [r*U, (r+1)*U), U = H/C a power of two, i.e. the G*U gate
//     columns g*H + r*U + u of wh; it copies that slice (packed by the wrapper as [G*U][H])
//     into shared memory once and keeps it for all T steps;
//   - every block holds the whole carry h of its BT rows in shared memory, in T (the carry
//     is only ever read rounded to T, so this is exact), double buffered;
//   - per step it computes h[BT,H] @ wh_slice[H,G*U]: bf16 on the tensor cores
//     (mma.sync.m16n8k16 from ldmatrix fragments, f32 accumulation), f32 with CUDA-core FMAs
//     in two halves of K (TF32 would break the f32 tolerance);
//   - it applies the gates to its own units, writes outs[t] and its slice of the new carry,
//     copies that slice into the next buffer of every other block of the cluster through
//     distributed shared memory (16-byte stores), issues the cp.async copies of step t+1's
//     x_proj slice and resets, and waits at one cluster barrier (release/acquire). The
//     double buffer makes one barrier per step enough: a buffer is rewritten only after
//     every block has passed the barrier that ends the step which read it.
// The launch plan (ops/cuda_rnn.py:launch_plan) keeps every cluster in one wave: on the H100
// at most 15 clusters of 8 (7 of 16) run at once with one block per SM.
//
// Design "rows" (gru_rows_kernel, lstm_rows_kernel: the first design, kept for the shapes
// whose wh slice does not fit a block even at C = 16, e.g. bf16 GRU at H=1024 or f32 LSTM
// at H=512). One block owns 4 batch rows and runs all T steps; wh is re-read from L2 each
// step with CUDA-core FMAs. The wrapper's launch plan picks the design from the shape.
//
// Plain C interface for ctypes. Pointers are device pointers, the stream is a cudaStream_t.
// Nothing is allocated here; each function returns a CUDA error code: the configuration
// check's, or cudaGetLastError() after its launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <utility>

namespace cg = cooperative_groups;

// Phase clock of the cluster kernel, built only with -DRNN_SEQ_PHASES (ops/rnn_seq_phases.py):
// thread 0 of every block adds the SM cycles of each phase of each step.
#ifdef RNN_SEQ_PHASES
__device__ unsigned long long rnn_seq_phase_cycles[4];  // product, gates, push + prefetch, barrier
#define PHASE_MARK(name) const long long name = clock64()
#define PHASE_ADD(i, from, to) \
    if (threadIdx.x == 0) atomicAdd(&rnn_seq_phase_cycles[i], static_cast<unsigned long long>((to) - (from)))
#else
#define PHASE_MARK(name)
#define PHASE_ADD(i, from, to)
#endif

namespace {

constexpr int kTile = 4;         // batch rows per block, design "rows"
constexpr int kThreads = 512;    // threads per block, design "cluster"

template <typename T>
struct Num;

template <>
struct Num<float> {
    __device__ __forceinline__ static float load(const float* p) { return *p; }
    __device__ __forceinline__ static float round(float x) { return x; }
    __device__ __forceinline__ static float to(float x) { return x; }
    __device__ __forceinline__ static uint2 pack8(const float (&v)[2]) {
        return make_uint2(__float_as_uint(v[0]), __float_as_uint(v[1]));
    }
};

template <>
struct Num<__nv_bfloat16> {
    __device__ __forceinline__ static float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
    __device__ __forceinline__ static float round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
    __device__ __forceinline__ static __nv_bfloat16 to(float x) { return __float2bfloat16_rn(x); }
    __device__ __forceinline__ static uint2 pack8(const float (&v)[4]) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]), hi = __floats2bfloat162_rn(v[2], v[3]);
        return make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
    }
};

// One elementwise op of the plain version: exact f32 op (no contraction), rounded to T.
template <typename T>
__device__ __forceinline__ float add(float a, float b) { return Num<T>::round(__fadd_rn(a, b)); }
template <typename T>
__device__ __forceinline__ float sub(float a, float b) { return Num<T>::round(__fsub_rn(a, b)); }
template <typename T>
__device__ __forceinline__ float mul(float a, float b) { return Num<T>::round(__fmul_rn(a, b)); }
template <typename T>
__device__ __forceinline__ float tanh_t(float x) { return Num<T>::round(tanhf(x)); }
template <typename T>
__device__ __forceinline__ float sigmoid_t(float x) {
    // 1 / (1 + exp(-x)), each of exp, + and / rounded to T
    const float e = Num<T>::round(expf(-x));
    return Num<T>::round(__fdiv_rn(1.0f, add<T>(1.0f, e)));
}

// ------------------------------------------------------------------ design "cluster"

// Padding of a shared-memory row, in elements: 16 bytes, so that the fragment loads of
// eight consecutive rows fall into distinct banks.
template <typename T>
__host__ __device__ constexpr int row_pad() { return 16 / static_cast<int>(sizeof(T)); }

// Dynamic shared memory of one block; ops/cuda_rnn.py:cluster_smem is the same formula.
inline size_t cluster_smem_bytes(int G, int H, int C, int BT, int elem) {
    const size_t U = H / C, N = G * U, HS = H + 16 / elem;
    const size_t partials = elem == 4 ? 2 : 1;  // the f32 product splits K in two halves
    return elem * (N * HS + 2 * BT * HS + 2 * BT * N) + 4 * (partials * BT * N + (G == 3 ? N : BT * U) + 2 * BT);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) { return static_cast<unsigned>(__cvta_generic_to_shared(p)); }

__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gmem_ptr) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem_ptr)), "l"(gmem_ptr) : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem_ptr, const void* gmem_ptr) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(smem_ptr)), "l"(gmem_ptr) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// ldmatrix: four (x4) or two (x2) 8x8 bf16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const __nv_bfloat16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm(uint32_t (&r)[2], const __nv_bfloat16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n" : "=r"(r[0]), "=r"(r[1]) : "r"(smem_addr(p)));
}

// d += a (16x16, row-major) * b (16x8, column-major), bf16 in, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
        "{%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The fragments of one k16 step: A (rows m0..m0+15) and B of NJ n8 tiles, by ldmatrix.
template <int NJ>
struct Frags {
    uint32_t a[4];
    uint32_t b[NJ][2];
    __device__ __forceinline__ void load(const __nv_bfloat16* pa, const __nv_bfloat16* pb, int k, int HS) {
        ldsm(a, pa + k);
#pragma unroll
        for (int j = 0; j + 1 < NJ; j += 2) {  // two n8 tiles per x4
            uint32_t r[4];
            ldsm(r, pb + j * 8 * HS + k);
            b[j][0] = r[0], b[j][1] = r[1], b[j + 1][0] = r[2], b[j + 1][1] = r[3];
        }
        if constexpr (NJ % 2 == 1) {
            uint32_t r[2];
            ldsm(r, pb + (NJ - 1) * 8 * HS + k);
            b[NJ - 1][0] = r[0], b[NJ - 1][1] = r[1];
        }
    }
    __device__ __forceinline__ void mma(float (&d)[NJ][4]) const {
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_bf16(d[j], a, b[j][0], b[j][1]);
    }
};

// acc[BT][N] = h[BT][0:H] @ w[N][0:H]^T on the tensor cores; rows of h and w have stride HS.
// A warp item is one m16 row tile times NJ n8 column tiles; the k loop loads step k+16's
// fragments before it issues step k's products.
template <int NJ>
__device__ __forceinline__ void product_tiles(const __nv_bfloat16* h, const __nv_bfloat16* w, float* acc, int BT,
                                              int N, int H, int HS) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    const int groups = N / (8 * NJ);
    for (int item = threadIdx.x >> 5; item < BT / 16 * groups; item += kThreads / 32) {
        const int m0 = item / groups * 16, n0 = item % groups * 8 * NJ;
        const __nv_bfloat16* pa = h + (m0 + (lane & 7) + (lane >> 3 & 1) * 8) * HS + (lane >> 4) * 8;
        const __nv_bfloat16* pb = w + (n0 + (lane >> 4) * 8 + (lane & 7)) * HS + (lane >> 3 & 1) * 8;
        float d[NJ][4] = {};
        Frags<NJ> f0, f1;
        f0.load(pa, pb, 0, HS);
        for (int k = 0; k < H; k += 32) {  // H is a multiple of 64
            f1.load(pa, pb, k + 16, HS);
            f0.mma(d);
            if (k + 32 < H) f0.load(pa, pb, k + 32, HS);
            f1.mma(d);
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            float* o = acc + (m0 + g) * N + n0 + j * 8 + 2 * q;
            *reinterpret_cast<float2*>(o) = make_float2(d[j][0], d[j][1]);
            *reinterpret_cast<float2*>(o + 8 * N) = make_float2(d[j][2], d[j][3]);
        }
    }
}

__device__ __forceinline__ void product(const __nv_bfloat16* h, const __nv_bfloat16* w, float* acc, int BT, int N,
                                        int H, int HS) {
    const int NT = N / 8;
    if (NT % 4 == 0)
        product_tiles<4>(h, w, acc, BT, N, H, HS);
    else if (NT % 2 == 0)
        product_tiles<2>(h, w, acc, BT, N, H, HS);
    else
        product_tiles<1>(h, w, acc, BT, N, H, HS);
}

// The same product in f32 on the CUDA cores. A thread computes 8 rows (BT is a multiple of
// 8 in f32) of columns j and j + N/2 (so that neighbouring threads read neighbouring rows of
// w) over one half of K; the halves go to acc[0] and acc[1] (acc + BT*N), which the gate
// math adds. Per 4 k, a warp reads 2 float4 of w per thread and 8 broadcast float4 of h for
// 64 FMAs: shared-memory wavefronts and FMA issue are balanced.
__device__ __forceinline__ void product(const float* h, const float* w, float* acc, int BT, int N, int H, int HS) {
    constexpr int RB = 8;
    const int half = N / 2, items = half * (BT / RB), K = H / 2;
    for (int idx = threadIdx.x; idx < 2 * items; idx += kThreads) {
        const int ks = idx >= items, it = idx - ks * items;
        const int j = it % half, r0 = it / half * RB;
        float s[RB][2] = {};
        const float* w0 = w + j * HS + ks * K;
        const float* w1 = w0 + half * HS;
        const float* hk = h + r0 * HS + ks * K;
        for (int k = 0; k < K; k += 4) {
            const float4 a = *reinterpret_cast<const float4*>(w0 + k);
            const float4 b = *reinterpret_cast<const float4*>(w1 + k);
#pragma unroll
            for (int i = 0; i < RB; ++i) {
                const float4 x = *reinterpret_cast<const float4*>(hk + i * HS + k);
                s[i][0] = fmaf(x.x, a.x, s[i][0]);
                s[i][0] = fmaf(x.y, a.y, s[i][0]);
                s[i][0] = fmaf(x.z, a.z, s[i][0]);
                s[i][0] = fmaf(x.w, a.w, s[i][0]);
                s[i][1] = fmaf(x.x, b.x, s[i][1]);
                s[i][1] = fmaf(x.y, b.y, s[i][1]);
                s[i][1] = fmaf(x.z, b.z, s[i][1]);
                s[i][1] = fmaf(x.w, b.w, s[i][1]);
            }
        }
        float* o = acc + ks * BT * N;
#pragma unroll
        for (int i = 0; i < RB; ++i) {
            o[(r0 + i) * N + j] = s[i][0];
            o[(r0 + i) * N + j + half] = s[i][1];
        }
    }
}

// h @ wh for the gates: one sum in bf16, the two K halves added in f32.
template <typename T>
__device__ __forceinline__ float product_at(const float* acc, int i, int BTN) {
    if constexpr (sizeof(T) == 4) return acc[i] + acc[BTN + i];
    return acc[i];
}

// Step t's inputs: this block's x_proj slice, BT rows x G runs of U elements -> xs[BT][G*U],
// and the tile's resets -> rs[BT]. U is a power of two (lu = log2 U).
template <typename T, int G>
__device__ __forceinline__ void prefetch(const T* x, const float* resets, T* xs, float* rs, int t, int B, int H,
                                         int b0, int BT, int r, int lu) {
    constexpr int E = 16 / sizeof(T);  // elements per 16-byte copy
    const int U = 1 << lu, lpg = lu - (sizeof(T) == 2 ? 3 : 2);  // log2 of the copies per gate run
    for (int row = threadIdx.x; row < BT && b0 + row < B; row += kThreads) cp_async4(rs + row, resets + (size_t)t * B + b0 + row);
    for (int i = threadIdx.x; i < (BT * G) << lpg; i += kThreads) {
        const int c = i & ((1 << lpg) - 1), rg = i >> lpg, row = rg / G, g = rg - row * G, b = b0 + row;
        if (b < B) cp_async16(xs + (row * G + g) * U + c * E, x + ((size_t)t * B + b) * G * H + g * H + r * U + c * E);
    }
}

template <typename T, int G>
__global__ void __launch_bounds__(kThreads, 1)
    seq_cluster_kernel(const T* __restrict__ x, const float* __restrict__ s0, const float* __restrict__ resets,
                       const T* __restrict__ wpk, const T* __restrict__ bh, float* __restrict__ outs,
                       float* __restrict__ s_final, int steps, int B, int H, int BT) {
    cg::cluster_group cluster = cg::this_cluster();
    const int C = static_cast<int>(cluster.dim_blocks().x);
    const int r = static_cast<int>(cluster.block_rank());
    const int U = H / C, lu = __ffs(U) - 1, N = G * U, HS = H + row_pad<T>(), SW = G == 3 ? H : 2 * H;
    const int b0 = static_cast<int>(blockIdx.x / C) * BT;
    constexpr int E = 8 / sizeof(T);  // units per thread in the gate math: 8 bytes of carry

    extern __shared__ __align__(16) unsigned char smem[];
    T* w_s = reinterpret_cast<T*>(smem);   // [N][HS]     this block's columns of wh, K contiguous
    T* h_s = w_s + N * HS;                 // [2][BT][HS] the whole carry h, double buffered
    T* x_s = h_s + 2 * BT * HS;            // [2][BT][N]  x_proj slice of steps t and t+1
    float* acc = reinterpret_cast<float*>(x_s + 2 * BT * N);  // [BT][N] h @ wh_slice (f32: [2][BT][N], K halves)
    float* aux = acc + (sizeof(T) == 4 ? 2 : 1) * BT * N;  // GRU: bh slice [N]; LSTM: cell state c [BT][U]
    float* rs = aux + (G == 3 ? N : BT * U);  // [2][BT] resets of steps t and t+1

    // wh slice: once per call
    const T* w_src = wpk + (size_t)r * N * H;
    const int w_chunks = H * static_cast<int>(sizeof(T)) / 16;
    for (int i = threadIdx.x; i < N * w_chunks; i += kThreads) {
        const int n = i / w_chunks, c = i % w_chunks;
        cp_async16(reinterpret_cast<uint4*>(w_s + n * HS) + c, reinterpret_cast<const uint4*>(w_src + (size_t)n * H) + c);
    }
    prefetch<T, G>(x, resets, x_s, rs, 0, B, H, b0, BT, r, lu);
    cp_async_commit();
    for (int i = threadIdx.x; i < BT * H; i += kThreads) {
        const int row = i / H, k = i % H, b = b0 + row;
        h_s[row * HS + k] = Num<T>::to(b < B ? Num<T>::round(s0[(size_t)b * SW + k]) : 0.0f);
    }
    if constexpr (G == 3) {
        for (int n = threadIdx.x; n < N; n += kThreads) aux[n] = Num<T>::load(bh + (n / U) * H + r * U + n % U);
    } else {
        for (int i = threadIdx.x; i < BT * U; i += kThreads) {
            const int row = i >> lu, b = b0 + row;
            aux[i] = b < B ? Num<T>::round(s0[(size_t)b * SW + H + r * U + (i & (U - 1))]) : 0.0f;
        }
    }
    cp_async_wait<0>();
    cluster.sync();  // every block of the cluster has started and holds its wh slice and h0

    for (int t = 0; t < steps; ++t) {
        PHASE_MARK(c0);
        const T* cur = h_s + (t & 1) * BT * HS;
        T* nxt = h_s + ((t + 1) & 1) * BT * HS;
        const T* xc = x_s + (t & 1) * BT * N;
        const float* rc = rs + (t & 1) * BT;

        product(cur, w_s, acc, BT, N, H, HS);
        PHASE_MARK(c1);
        cp_async_wait<0>();  // step t's x_proj has landed
        __syncthreads();

        // Each thread takes 8 bytes' worth of neighbouring units of one row (4 in bf16, 2 in
        // f32) and writes their new carries into this block's next buffer.
        for (int i = threadIdx.x; i < BT * U / E; i += kThreads) {
            const int row = (E * i) >> lu, u0 = (E * i) & (U - 1), b = b0 + row;
            const bool live = b < B, keep = live && !(rc[row] > 0.0f);
            float out[E], carry[E];
#pragma unroll
            for (int e = 0; e < E; ++e) {
                const int u = u0 + e;
                const int a = row * N + u, BTN = BT * N;
                const T* xp = xc + row * N + u;
                if constexpr (G == 3) {
                    const float hr = add<T>(Num<T>::round(product_at<T>(acc, a, BTN)), aux[u]);
                    const float hz = add<T>(Num<T>::round(product_at<T>(acc, a + U, BTN)), aux[U + u]);
                    const float hn = add<T>(Num<T>::round(product_at<T>(acc, a + 2 * U, BTN)), aux[2 * U + u]);
                    const float rg = sigmoid_t<T>(add<T>(Num<T>::load(xp), hr));
                    const float zg = sigmoid_t<T>(add<T>(Num<T>::load(xp + U), hz));
                    const float n = tanh_t<T>(add<T>(Num<T>::load(xp + 2 * U), mul<T>(rg, hn)));
                    const float h = Num<T>::load(cur + row * HS + r * U + u);
                    out[e] = add<T>(mul<T>(sub<T>(1.0f, zg), n), mul<T>(zg, h));
                } else {
                    const float pi = add<T>(Num<T>::load(xp), Num<T>::round(product_at<T>(acc, a, BTN)));
                    const float pf = add<T>(Num<T>::load(xp + U), Num<T>::round(product_at<T>(acc, a + U, BTN)));
                    const float pg = add<T>(Num<T>::load(xp + 2 * U), Num<T>::round(product_at<T>(acc, a + 2 * U, BTN)));
                    const float po = add<T>(Num<T>::load(xp + 3 * U), Num<T>::round(product_at<T>(acc, a + 3 * U, BTN)));
                    float* c = aux + row * U + u;
                    const float new_c =
                        add<T>(mul<T>(sigmoid_t<T>(add<T>(pf, 1.0f)), *c), mul<T>(sigmoid_t<T>(pi), tanh_t<T>(pg)));
                    out[e] = mul<T>(sigmoid_t<T>(po), tanh_t<T>(new_c));
                    *c = keep ? new_c : 0.0f;
                }
                carry[e] = keep ? out[e] : 0.0f;
            }
            if (live) {
                float* o = outs + ((size_t)t * B + b) * H + r * U + u0;
#pragma unroll
                for (int e = 0; e < E; e += 2) *reinterpret_cast<float2*>(o + e) = make_float2(out[e], out[e + 1]);
            }
            *reinterpret_cast<uint2*>(nxt + row * HS + r * U + u0) = Num<T>::pack8(carry);
        }
        __syncthreads();
        PHASE_MARK(c2);

        // this block's slice of the new carry into the next buffer of every other block, in
        // 16-byte stores: on the H100 a remote store costs about the same at 4 and at 16 bytes
        const int lpr = lu - (sizeof(T) == 2 ? 3 : 2);  // log2 of the 16-byte pieces of a row's slice
        for (int p = 1, peer = r + 1; p < C; ++p, ++peer) {
            const int dst = peer < C ? peer : peer - C;
            for (int i = threadIdx.x; i < BT << lpr; i += kThreads) {
                uint4* src = reinterpret_cast<uint4*>(nxt + (i >> lpr) * HS + r * U) + (i & ((1 << lpr) - 1));
                *cluster.map_shared_rank(src, dst) = *src;
            }
        }
        // step t+1's inputs, into the buffers that step t-1 read
        if (t + 1 < steps) prefetch<T, G>(x, resets, x_s + ((t + 1) & 1) * BT * N, rs + ((t + 1) & 1) * BT, t + 1, B, H, b0, BT, r, lu);
        cp_async_commit();
        PHASE_MARK(c3);
        cluster.sync();  // barrier.cluster arrive.release / wait.acquire: the peers' slices are visible
        PHASE_MARK(c4);
        PHASE_ADD(0, c0, c1);
        PHASE_ADD(1, c1, c2);
        PHASE_ADD(2, c2, c3);
        PHASE_ADD(3, c3, c4);
    }

    // the last barrier above is every block's last access to a peer's shared memory
    const T* fin = h_s + (steps & 1) * BT * HS;
    for (int i = threadIdx.x; i < BT * U; i += kThreads) {
        const int row = i >> lu, u = i & (U - 1), b = b0 + row;
        if (b >= B) continue;
        s_final[(size_t)b * SW + r * U + u] = Num<T>::load(fin + row * HS + r * U + u);
        if constexpr (G == 4) s_final[(size_t)b * SW + H + r * U + u] = aux[i];
    }
}

template <typename T, int G>
int launch_cluster(const void* x, const void* s0, const void* resets, const void* wpk, const void* bh, void* outs,
                   void* s_final, int steps, int B, int H, int C, int BT, int smem, cudaStream_t stream) {
    const int m = sizeof(T) == 2 ? 16 : 8;  // row granularity: the mma's m16, or the f32 product's 8-row groups
    if (C < 1 || C > 16 || H % C != 0 || H / C < 8 || (H / C & (H / C - 1)) != 0 || BT < m || BT % m != 0 ||
        (size_t)smem != cluster_smem_bytes(G, H, C, BT, sizeof(T)))
        return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = seq_cluster_kernel<T, G>;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(((B + BT - 1) / BT) * C);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;

    // The function attributes and the check that a cluster fits on the card, once per
    // configuration and process (they cost tens of microseconds of host time).
    static std::mutex lock;
    static int smem_set = 0;
    static std::set<std::pair<int, int>> checked;  // (C, smem)
    cudaError_t err = cudaSuccess;
    {
        std::lock_guard<std::mutex> guard(lock);
        if (smem > smem_set) {
            err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
            if (err != cudaSuccess) return static_cast<int>(err);
            smem_set = smem;
        }
        if (!checked.count({C, smem})) {
            int clusters = 0;
            err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
            if (err != cudaSuccess) return static_cast<int>(err);
            if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
            checked.insert({C, smem});
        }
    }
    err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), static_cast<const float*>(s0),
                             static_cast<const float*>(resets), static_cast<const T*>(wpk), static_cast<const T*>(bh),
                             static_cast<float*>(outs), static_cast<float*>(s_final), steps, B, H, BT);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ design "rows"

template <typename T>
__global__ void gru_rows_kernel(const T* __restrict__ x, const float* __restrict__ h0,
                                const float* __restrict__ resets, const T* __restrict__ wh,
                                const T* __restrict__ bh, float* __restrict__ outs,
                                float* __restrict__ h_final, int steps, int B, int H) {
    extern __shared__ float rows_smem[];  // [2][kTile][H]
    float* h_cur = rows_smem;
    float* h_next = rows_smem + kTile * H;
    const int G = 3 * H;
    const int b0 = blockIdx.x * kTile;

    // the carry is only ever used as a T operand, so it is kept rounded to T
    for (int i = threadIdx.x; i < kTile * H; i += blockDim.x) {
        const int b = b0 + i / H;
        h_cur[i] = b < B ? Num<T>::round(h0[(size_t)b * H + i % H]) : 0.0f;
    }
    __syncthreads();

    for (int t = 0; t < steps; ++t) {
        for (int j = threadIdx.x; j < H; j += blockDim.x) {
            float ar[kTile], az[kTile], an[kTile];
#pragma unroll
            for (int r = 0; r < kTile; ++r) ar[r] = az[r] = an[r] = 0.0f;
#pragma unroll 4
            for (int k = 0; k < H; ++k) {
                const T* w = wh + (size_t)k * G + j;
                const float wr = Num<T>::load(w), wz = Num<T>::load(w + H), wn = Num<T>::load(w + 2 * H);
#pragma unroll
                for (int r = 0; r < kTile; ++r) {
                    const float hk = h_cur[r * H + k];
                    ar[r] = fmaf(hk, wr, ar[r]);
                    az[r] = fmaf(hk, wz, az[r]);
                    an[r] = fmaf(hk, wn, an[r]);
                }
            }
            const float bhr = Num<T>::load(bh + j), bhz = Num<T>::load(bh + H + j), bhn = Num<T>::load(bh + 2 * H + j);
#pragma unroll
            for (int r = 0; r < kTile; ++r) {
                const int b = b0 + r;
                if (b >= B) {
                    h_next[r * H + j] = 0.0f;
                    continue;
                }
                const T* xp = x + ((size_t)t * B + b) * G + j;
                const float hr = add<T>(Num<T>::round(ar[r]), bhr);
                const float hz = add<T>(Num<T>::round(az[r]), bhz);
                const float hn = add<T>(Num<T>::round(an[r]), bhn);
                const float rg = sigmoid_t<T>(add<T>(Num<T>::load(xp), hr));
                const float zg = sigmoid_t<T>(add<T>(Num<T>::load(xp + H), hz));
                const float n = tanh_t<T>(add<T>(Num<T>::load(xp + 2 * H), mul<T>(rg, hn)));
                const float h = h_cur[r * H + j];
                const float new_h = add<T>(mul<T>(sub<T>(1.0f, zg), n), mul<T>(zg, h));
                outs[((size_t)t * B + b) * H + j] = new_h;
                h_next[r * H + j] = resets[(size_t)t * B + b] > 0.0f ? 0.0f : new_h;
            }
        }
        __syncthreads();
        float* tmp = h_cur;
        h_cur = h_next;
        h_next = tmp;
    }

    for (int i = threadIdx.x; i < kTile * H; i += blockDim.x) {
        const int b = b0 + i / H;
        if (b < B) h_final[(size_t)b * H + i % H] = h_cur[i];
    }
}

template <typename T>
__global__ void lstm_rows_kernel(const T* __restrict__ x, const float* __restrict__ hc0,
                                 const float* __restrict__ resets, const T* __restrict__ wh,
                                 float* __restrict__ outs, float* __restrict__ hc_final, int steps, int B,
                                 int H) {
    extern __shared__ float rows_smem[];  // h: [2][kTile][H], c: [kTile][H] (c is touched by its owning thread only)
    float* h_cur = rows_smem;
    float* h_next = rows_smem + kTile * H;
    float* c = rows_smem + 2 * kTile * H;
    const int G = 4 * H;
    const int b0 = blockIdx.x * kTile;

    for (int i = threadIdx.x; i < kTile * H; i += blockDim.x) {
        const int b = b0 + i / H, k = i % H;
        h_cur[i] = b < B ? Num<T>::round(hc0[(size_t)b * 2 * H + k]) : 0.0f;
        c[i] = b < B ? Num<T>::round(hc0[(size_t)b * 2 * H + H + k]) : 0.0f;
    }
    __syncthreads();

    for (int t = 0; t < steps; ++t) {
        for (int j = threadIdx.x; j < H; j += blockDim.x) {
            float ai[kTile], af[kTile], ag[kTile], ao[kTile];
#pragma unroll
            for (int r = 0; r < kTile; ++r) ai[r] = af[r] = ag[r] = ao[r] = 0.0f;
#pragma unroll 4
            for (int k = 0; k < H; ++k) {
                const T* w = wh + (size_t)k * G + j;
                const float wi = Num<T>::load(w), wf = Num<T>::load(w + H);
                const float wg = Num<T>::load(w + 2 * H), wo = Num<T>::load(w + 3 * H);
#pragma unroll
                for (int r = 0; r < kTile; ++r) {
                    const float hk = h_cur[r * H + k];
                    ai[r] = fmaf(hk, wi, ai[r]);
                    af[r] = fmaf(hk, wf, af[r]);
                    ag[r] = fmaf(hk, wg, ag[r]);
                    ao[r] = fmaf(hk, wo, ao[r]);
                }
            }
#pragma unroll
            for (int r = 0; r < kTile; ++r) {
                const int b = b0 + r;
                if (b >= B) {
                    h_next[r * H + j] = 0.0f;
                    continue;
                }
                const T* xp = x + ((size_t)t * B + b) * G + j;
                const float pi = add<T>(Num<T>::load(xp), Num<T>::round(ai[r]));
                const float pf = add<T>(Num<T>::load(xp + H), Num<T>::round(af[r]));
                const float pg = add<T>(Num<T>::load(xp + 2 * H), Num<T>::round(ag[r]));
                const float po = add<T>(Num<T>::load(xp + 3 * H), Num<T>::round(ao[r]));
                const float new_c = add<T>(mul<T>(sigmoid_t<T>(add<T>(pf, 1.0f)), c[r * H + j]),
                                           mul<T>(sigmoid_t<T>(pi), tanh_t<T>(pg)));
                const float new_h = mul<T>(sigmoid_t<T>(po), tanh_t<T>(new_c));
                outs[((size_t)t * B + b) * H + j] = new_h;
                const bool reset = resets[(size_t)t * B + b] > 0.0f;
                h_next[r * H + j] = reset ? 0.0f : new_h;
                c[r * H + j] = reset ? 0.0f : new_c;
            }
        }
        __syncthreads();
        float* tmp = h_cur;
        h_cur = h_next;
        h_next = tmp;
    }

    for (int i = threadIdx.x; i < kTile * H; i += blockDim.x) {
        const int b = b0 + i / H, k = i % H;
        if (b < B) {
            hc_final[(size_t)b * 2 * H + k] = h_cur[i];
            hc_final[(size_t)b * 2 * H + H + k] = c[i];
        }
    }
}

inline int block_threads(int H) {
    const int warps = (H + 31) / 32;
    return warps * 32 < 256 ? warps * 32 : 256;
}

}  // namespace

extern "C" {

// Design "cluster": wpk is wh packed by ops/cuda_rnn.py:pack_wh as [C][3*U][H].
int gru_seq_forward(const void* x, const void* h0, const void* resets, const void* wpk, const void* bh, void* outs,
                    void* h_final, int steps, int B, int H, int is_bf16, int cluster, int rows, int smem,
                    void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return is_bf16 ? launch_cluster<__nv_bfloat16, 3>(x, h0, resets, wpk, bh, outs, h_final, steps, B, H, cluster,
                                                      rows, smem, s)
                   : launch_cluster<float, 3>(x, h0, resets, wpk, bh, outs, h_final, steps, B, H, cluster, rows,
                                              smem, s);
}

int lstm_seq_forward(const void* x, const void* hc0, const void* resets, const void* wpk, void* outs, void* hc_final,
                     int steps, int B, int H, int is_bf16, int cluster, int rows, int smem, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return is_bf16 ? launch_cluster<__nv_bfloat16, 4>(x, hc0, resets, wpk, nullptr, outs, hc_final, steps, B, H,
                                                      cluster, rows, smem, s)
                   : launch_cluster<float, 4>(x, hc0, resets, wpk, nullptr, outs, hc_final, steps, B, H, cluster,
                                              rows, smem, s);
}

// Clusters of `cluster` blocks with `smem` bytes each that the card runs at once (0 if none).
int max_active_clusters(int gates, int is_bf16, int cluster, int smem) {
    auto query = [&](auto kernel) {
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = cluster;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(cluster * 64);
        cfg.blockDim = dim3(kThreads);
        cfg.dynamicSmemBytes = smem;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        int n = 0;
        return cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess ? n : 0;
    };
    if (gates == 3) return is_bf16 ? query(seq_cluster_kernel<__nv_bfloat16, 3>) : query(seq_cluster_kernel<float, 3>);
    return is_bf16 ? query(seq_cluster_kernel<__nv_bfloat16, 4>) : query(seq_cluster_kernel<float, 4>);
}

#ifdef RNN_SEQ_PHASES
int rnn_seq_phases_read(void* out) {
    return static_cast<int>(cudaMemcpyFromSymbol(out, rnn_seq_phase_cycles, sizeof(rnn_seq_phase_cycles)));
}
int rnn_seq_phases_reset() {
    const unsigned long long zero[4] = {};
    return static_cast<int>(cudaMemcpyToSymbol(rnn_seq_phase_cycles, zero, sizeof(zero)));
}
#endif

// Design "rows": wh as given, [H][3H] / [H][4H].
int gru_rows_forward(const void* x, const void* h0, const void* resets, const void* wh, const void* bh, void* outs,
                     void* h_final, int steps, int B, int H, int is_bf16, void* stream) {
    const dim3 grid((B + kTile - 1) / kTile);
    const size_t smem = 2 * kTile * H * sizeof(float);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16) {
        gru_rows_kernel<__nv_bfloat16><<<grid, block_threads(H), smem, s>>>(
            static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(h0), static_cast<const float*>(resets),
            static_cast<const __nv_bfloat16*>(wh), static_cast<const __nv_bfloat16*>(bh), static_cast<float*>(outs),
            static_cast<float*>(h_final), steps, B, H);
    } else {
        gru_rows_kernel<float><<<grid, block_threads(H), smem, s>>>(
            static_cast<const float*>(x), static_cast<const float*>(h0), static_cast<const float*>(resets),
            static_cast<const float*>(wh), static_cast<const float*>(bh), static_cast<float*>(outs),
            static_cast<float*>(h_final), steps, B, H);
    }
    return static_cast<int>(cudaGetLastError());
}

int lstm_rows_forward(const void* x, const void* hc0, const void* resets, const void* wh, void* outs, void* hc_final,
                      int steps, int B, int H, int is_bf16, void* stream) {
    const dim3 grid((B + kTile - 1) / kTile);
    const size_t smem = 3 * kTile * H * sizeof(float);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16) {
        lstm_rows_kernel<__nv_bfloat16><<<grid, block_threads(H), smem, s>>>(
            static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(hc0), static_cast<const float*>(resets),
            static_cast<const __nv_bfloat16*>(wh), static_cast<float*>(outs), static_cast<float*>(hc_final), steps, B,
            H);
    } else {
        lstm_rows_kernel<float><<<grid, block_threads(H), smem, s>>>(
            static_cast<const float*>(x), static_cast<const float*>(hc0), static_cast<const float*>(resets),
            static_cast<const float*>(wh), static_cast<float*>(outs), static_cast<float*>(hc_final), steps, B, H);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
