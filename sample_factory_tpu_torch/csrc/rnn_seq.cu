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
// Design. The TPU kernel walks a (batch tile, T) grid in order and keeps wh resident in
// VMEM. On Hopper wh does not fit one block's shared memory at the sizes used (bf16 wh is
// 384 KB at H=256), but the recurrence is independent across batch rows: one block owns a
// tile of BT rows and loops over T by itself, with no grid-wide barrier. The tile's carry
// lives in shared memory (double buffered: every thread reads all of h for the product,
// then writes its own units of h'); wh is read from global memory each step and stays in
// the 50 MB L2. Thread j owns hidden unit j (and j + blockDim, ...) and computes its three
// (GRU) or four (LSTM) gate columns for all BT rows, so the gate math needs no exchange.
//
// Bound on the H100: at the main-path shape (T=32, B=512, H=256, bf16) the function must
// move ~43 MB (x_proj, outs, states, wh) against ~6.4 GFLOP, so HBM bandwidth bounds it
// (~13 us at 3.35 TB/s). This first design re-reads wh from L2 once per block and step
// and uses CUDA-core FMAs, not wgmma; L2 bandwidth and the per-step latency chain limit it.
//
// Plain C interface for ctypes. Pointers are device pointers, the stream is a cudaStream_t.
// Nothing is allocated here; each function returns cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 4;  // batch rows per block

template <typename T>
struct Num;

template <>
struct Num<float> {
    __device__ __forceinline__ static float load(const float* p) { return *p; }
    __device__ __forceinline__ static float round(float x) { return x; }
};

template <>
struct Num<__nv_bfloat16> {
    __device__ __forceinline__ static float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
    __device__ __forceinline__ static float round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
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

template <typename T>
__global__ void gru_seq_kernel(const T* __restrict__ x, const float* __restrict__ h0,
                               const float* __restrict__ resets, const T* __restrict__ wh,
                               const T* __restrict__ bh, float* __restrict__ outs,
                               float* __restrict__ h_final, int steps, int B, int H) {
    extern __shared__ float smem[];  // [2][kTile][H]
    float* h_cur = smem;
    float* h_next = smem + kTile * H;
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
__global__ void lstm_seq_kernel(const T* __restrict__ x, const float* __restrict__ hc0,
                                const float* __restrict__ resets, const T* __restrict__ wh,
                                float* __restrict__ outs, float* __restrict__ hc_final, int steps, int B,
                                int H) {
    extern __shared__ float smem[];  // h: [2][kTile][H], c: [kTile][H] (c is touched by its owning thread only)
    float* h_cur = smem;
    float* h_next = smem + kTile * H;
    float* c = smem + 2 * kTile * H;
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

int gru_seq_forward(const void* x, const void* h0, const void* resets, const void* wh, const void* bh, void* outs,
                    void* h_final, int steps, int B, int H, int is_bf16, void* stream) {
    const dim3 grid((B + kTile - 1) / kTile);
    const size_t smem = 2 * kTile * H * sizeof(float);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16) {
        gru_seq_kernel<__nv_bfloat16><<<grid, block_threads(H), smem, s>>>(
            static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(h0), static_cast<const float*>(resets),
            static_cast<const __nv_bfloat16*>(wh), static_cast<const __nv_bfloat16*>(bh), static_cast<float*>(outs),
            static_cast<float*>(h_final), steps, B, H);
    } else {
        gru_seq_kernel<float><<<grid, block_threads(H), smem, s>>>(
            static_cast<const float*>(x), static_cast<const float*>(h0), static_cast<const float*>(resets),
            static_cast<const float*>(wh), static_cast<const float*>(bh), static_cast<float*>(outs),
            static_cast<float*>(h_final), steps, B, H);
    }
    return static_cast<int>(cudaGetLastError());
}

int lstm_seq_forward(const void* x, const void* hc0, const void* resets, const void* wh, void* outs, void* hc_final,
                     int steps, int B, int H, int is_bf16, void* stream) {
    const dim3 grid((B + kTile - 1) / kTile);
    const size_t smem = 3 * kTile * H * sizeof(float);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16) {
        lstm_seq_kernel<__nv_bfloat16><<<grid, block_threads(H), smem, s>>>(
            static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(hc0), static_cast<const float*>(resets),
            static_cast<const __nv_bfloat16*>(wh), static_cast<float*>(outs), static_cast<float*>(hc_final), steps, B,
            H);
    } else {
        lstm_seq_kernel<float><<<grid, block_threads(H), smem, s>>>(
            static_cast<const float*>(x), static_cast<const float*>(hc0), static_cast<const float*>(resets),
            static_cast<const float*>(wh), static_cast<float*>(outs), static_cast<float*>(hc_final), steps, B, H);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
