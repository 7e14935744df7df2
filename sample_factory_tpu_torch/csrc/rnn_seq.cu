// GRU and LSTM recurrences over one BPTT segment, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of sample_factory_tpu/ops/pallas_gru.py:
//   gru_seq_forward, gru_rows_forward, gru_grid_forward                           <- _gru_kernel  (:78-109, pallas_call at :148)
//   lstm_seq_forward, lstm_rows_forward, lstm_grid_forward, lstm_resident_forward <- _lstm_kernel (:226-253, pallas_call at :271)
// and the backward rules of their custom_vjps:
//   gru_seq_backward, gru_seq_grid_backward, gru_seq_cluster_backward    <- _bwd      (:189-195, jax.vjp of the scan)
//   lstm_seq_backward, lstm_seq_grid_backward, lstm_seq_cluster_backward,
//   lstm_seq_resident_backward                                           <- _lstm_bwd (:311-315)
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
// The launch plan (ops/cuda_rnn.py:launch_plan) keeps every cluster in one wave, from the counts
// the card reports (cuda_rnn.card_spec): the H100 SXM runs at most 15 clusters of 8 (7 of 16) at
// once with one block per SM; a size of which the card runs none is never planned.
//
// Design "grid" (grid_kernel<Cells>, the f32 GRU and LSTM where no cluster slice fits, e.g. H=512:
// an LSTM slice of 16 would need 128 x 516 x 4 = 264 KB, a GRU slice 238 KB). Also replaces
// _gru_kernel and _lstm_kernel; one kernel, templated over the cell (LstmCells, GruCells). What
// bounds it: at large B the f32 product on the CUDA cores, 2*B*H*G*H operations a step at 67
// TFLOP/s (64 us at B=2048, H=512, G=4); at small B the chain of T dependent steps, each a grid
// barrier and an L2 round trip of the new carry. The design:
//   - one persistent cooperative launch for all T steps: Q batch tiles x S unit slices,
//     Q*S <= the card's SMs (132 on the H100 SXM), one a SM, all resident (cudaLaunchCooperativeKernel refuses a grid
//     that does not fit); one grid barrier (cg::this_grid().sync()) a step;
//   - block (q, r) owns BT batch rows and U = H/S hidden units with all G gates of each, the
//     G*U columns of wh that pack_wh lays out for it; it copies them into shared memory once
//     and keeps them for all T steps (weight-stationary: 32 KB at U=4, 128 KB at U=16; the
//     GRU's columns padded with a zero fourth gate, so both cells share the tiles below);
//   - only h crosses blocks: the new carry goes to a global double buffer [2][B][H] that the
//     wrapper allocates, and every block reads its tile's h at the next step with cp.async.cg
//     (L2 only, so no L1 line of an earlier step is read), in K chunks of up to 128, double
//     buffered; the LSTM's cell state stays with its owning thread (in hc_final's c half, which
//     only that thread touches until the end), and so does the GRU's old h, which that thread
//     wrote into the h buffer the step before; the GRU's bh sits in the thread's registers;
//   - the product h[BT,H] @ wh_slice[H,4U] in f32 FMAs (no TF32: it would break the f32
//     tolerance), a register tile of TM x TN a thread (TN/4 units x 4 gates, so the cells
//     are applied from registers); at small B 4 x 4 tiles with the K range split 8 or 4 ways
//     across threads (partial sums added through shared memory, a cell a thread), at large B
//     8 x 8 tiles at 256 threads (a thread's 64 accumulators and operands fill its 255
//     registers; larger tiles spill) in passes over the tile's rows;
//   - a cell's x_proj, c (h) and reset are loaded before they are needed: ahead of the product
//     where a thread owns one cell, a row ahead where it owns a tile's; step t+1's x_proj slice
//     and resets are prefetched into L2 during step t (a prefetch, not a copy into shared
//     memory: at B=2048 a block's slice is 128 KB a step).
// The plan (ops/cuda_rnn.py:grid_plan) takes at small B one batch tile and many narrow slices
// (S=128, U=4: the whole card shares each step's product), at large B four batch tiles of wide
// slices (S=32, U=16: the L2 reads of h, S*B*H*4 bytes a step, fall fourfold).
//
// Design "rows" (gru_rows_kernel, lstm_rows_kernel: the first design, kept for the shapes
// whose wh slice does not fit a block even at C = 16 and that the grid design does not take,
// e.g. bf16 GRU at H=1024 or f32 at H=100, and the GRU at H <= 64 where a cluster plan needs
// several waves). One block owns 4 batch rows and runs all T steps; wh is re-read from L2 each
// step with CUDA-core FMAs. The wrapper's launch plan picks the design from the shape.
//
// Design "resident" (lstm_resident_kernel and lstm_resident_bwd_kernel, the LSTM at H <= 64, in place
// of the cluster and row designs: all of wh in one block's shared memory for all T steps; its note is
// at the kernels, near the end of this file).
//
// Backward (seq_bwd_kernel<T, G, R>; C entries gru_seq_backward, lstm_seq_backward; counted as gru_seq_bwd and
// lstm_seq_bwd). Replaces the backward rules of the custom_vjps of sample_factory_tpu/ops/pallas_gru.py, `_bwd`
// (:189-195) and `_lstm_bwd` (:311-315): jax.vjp of the lax.scan reference, no pallas_call, which XLA compiles into
// one reverse-time loop on the device. ops/cuda_rnn.py runs a prologue before it (the carry entering each step,
// from h0, the forward's saved outputs and the resets, and its projection: one product over T*B rows) and an
// epilogue after it (d_wh = h_prev^T @ d_h_proj over T*B rows). The kernel runs the recurrence in
// reverse time, t = T-1 .. 0, with g the cotangent of step t's new state (d_outs[t], plus the carried one where
// resets[t] is 0):
//   GRU : dn = g(1-z), da_n = dn(1-n^2), da_r = da_n*hn*r(1-r), da_z = g(h-n)*z(1-z); d_x_proj = [da_r, da_z, da_n],
//         d_h_proj = [da_r, da_z, d_hn], d_hn = da_n*r; dh_prev = g*z + d_h_proj @ wh^T. Only d_hn [T,B,H] is
//         written beside d_x_proj: the epilogue reads d_h_proj's r and z columns from d_x_proj
//   LSTM: dc_tot = dc + dh*o*(1-tanh^2 c'); the gates' cotangents as the forward's chain rule gives them;
//         dc_prev = dc_tot*f; dh_prev = d_x_proj @ wh^T (the cell state entering each step is recomputed first,
//         forward in time, each op rounded to T as the forward rounds it, into a scratch buffer)
// The gates are recomputed from the staged pre-activations in T; a sigmoid whose argument lies below -88 gets
// gradient 0 (the plain version's clamp). Gradient math and the product are f32 FMAs on the CUDA cores (TF32
// would break the f32 tolerance). Design: the row design mirrored. A block owns R batch rows (R = 1, 2, 4 or 8:
// the largest power of two at most B / SMs, so that there are at least as many blocks as SMs where B allows,
// lowered until its shared memory fits; ops/cuda_rnn.py:bwd_rows) and all H units, so no block waits on another:
// no cooperative launch, no cluster. It keeps its rows' carried cotangents dh (and dc) and the step's gate
// cotangents [R][G*H] in shared memory (dynamic, above 48 KB at R=8, H=512), and stages the next step's inputs
// there with cp.async while the product runs. The product reads wh^T [G*H][H] (packed by the wrapper once a call)
// from L2, thread k owning unit k of every row. What bounds it: each block reads all of wh^T every step (G*H*H
// elements: 3 MB at the f32 GRU-512), so the L2 reads and the latency of the loads, not HBM and not the
// 2*T*B*G*H*H operations.
//
// Backward, design "grid" (seq_bwd_grid_kernel<Cells>; C entries gru_seq_grid_backward, lstm_seq_grid_backward; counted
// as gru_seq_grid_bwd and lstm_seq_grid_bwd): float32, planned exactly where the forward takes its grid design (H=512 on
// the Doom, NetHack and AllegroHandLSTM learners, `tp`'s multichip leg and the defaults). The forward's skeleton run
// backwards: one persistent cooperative launch of Q batch tiles x S unit slices, at most one block an SM; block (q, r)
// owns the U units r*U .. r*U+U-1 of its tile's rows and keeps wh's rows of those units, [G*H][U] f32 (32 KB at U=4,
// 128 KB at U=16 for the LSTM-512), in shared memory for all T steps, where the row design re-reads all of wh^T from L2
// every step. Everything but the product dh_prev = dg @ wh^T is local to a unit (the carried cotangents, the gates,
// d_x_proj, the LSTM's recomputed cell state), so only the gate cotangents dg cross blocks, and they need no buffer of
// their own: dg[t] is d_x_proj[t] (LSTM) or d_x_proj[t][:, :2H] ++ d_hn[t] (GRU), which the cells write anyway, a new t
// each step. A step: the cells write dg[t]; one grid barrier; each block reads its tile's rows of dg[t] from L2
// (cp.async.cg, never L1) in K chunks, double buffered, and multiplies them by its slice in f32 FMAs: 4 x 4
// accumulators a thread, K split up to 32 ways at small B (partial sums through shared memory).
// What bounds it: at large B the product's FMAs and its shared-memory reads, and the L2 reads of dg (S*B*G*H*4 bytes
// a step: the plan takes the widest slices, U=16, that keep the blocks many); at small B the chain of T steps, each a
// barrier and an L2 round trip.
//
// Backward, design "cluster" (seq_bwd_cluster_kernel<T, G>; C entries gru_seq_cluster_backward, lstm_seq_cluster_backward;
// counted as gru_seq_cluster_bwd and lstm_seq_cluster_bwd): planned exactly where the forward takes its cluster design (bf16,
// and float32 at H <= 256), with the forward's cluster and unit slice. The forward's cluster design mirrored: block r keeps
// the forward's slice of wh (pack_wh's rows of its units' G*U gate columns) in shared memory for all T steps, where the row
// design re-reads all of wh^T from L2 every step. Everything but the product dh_prev = dg @ wh^T is local to a unit, and a
// block holds the gate cotangents dg of its own units only, so each block computes the partial product of its G*U columns
// of dg with its slice, [BT][H] over K = G*U, and sends each peer the [BT][U] columns of that peer's units through
// distributed shared memory into its receive slot r; after one cluster barrier a step each block sums its C slots in block
// order (the result does not depend on arrival) and adds the direct term (the GRU's g*z). Exchanging dg itself would move G
// times the data. The product: bf16 on the tensor cores (mma.sync.m16n8k16; dg, f32 as the row design keeps it, split into a
// bf16 high part and remainder, two mmas into one f32 sum, so it keeps f32 to about 2^-16 against an exact bf16 wh; B read
// from the forward's [K][H] layout by ldmatrix.trans), f32 in FMAs on the CUDA cores (no TF32). What bounds it: the chain of
// T steps, each the cells, the product, its remote stores and a cluster barrier; not HBM.
//
// Plain C interface for ctypes. Pointers are device pointers, the stream is a cudaStream_t.
// Nothing is allocated here; each function returns a CUDA error code: the configuration
// check's, or cudaGetLastError() after its launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <set>
#include <type_traits>
#include <utility>

namespace cg = cooperative_groups;

// Phase clock of the cluster kernel, built only with -DRNN_SEQ_PHASES (ops/rnn_seq_phases.py):
// thread 0 of every block adds the SM cycles of each phase of each step. Two more measurement builds of that tool, whose
// results are wrong by design: -DRNN_SEQ_BWD_ABLATE_LOADS leaves out the grid backward's loads of dg, and
// -DRNN_SEQ_BWD_ABLATE_PRODUCT its product, so that each one's time shows apart.
#ifdef RNN_SEQ_PHASES
// product, gates, push + prefetch, barrier; the fifth: the cluster backward's remote stores, inside its product phase
__device__ unsigned long long rnn_seq_phase_cycles[5];
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

// A runtime call that fails also leaves its error as the thread's last error, which the next
// launch's cudaGetLastError() would report as its own: a launcher that returns a failed call's
// code takes the error back first.
static int failed(cudaError_t err) {
    (void)cudaGetLastError();
    return static_cast<int>(err);
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
    // configuration, device and process (they cost tens of microseconds of host time; an
    // attribute holds for the device that was current when it was set).
    static std::mutex lock;
    static std::map<int, int> smem_set;                          // device -> the limit set there
    static std::set<std::pair<int, std::pair<int, int>>> checked;  // (device, (C, smem))
    cudaError_t err = cudaSuccess;
    {
        std::lock_guard<std::mutex> guard(lock);
        int dev = 0;
        err = cudaGetDevice(&dev);
        if (err != cudaSuccess) return failed(err);
        if (smem > smem_set[dev]) {
            err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
            if (err != cudaSuccess) return failed(err);
            smem_set[dev] = smem;
        }
        if (!checked.count({dev, {C, smem}})) {
            int clusters = 0;
            err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
            if (err != cudaSuccess) return failed(err);
            if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);  // refused: no cluster of C fits
            checked.insert({dev, {C, smem}});
        }
    }
    err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), static_cast<const float*>(s0),
                             static_cast<const float*>(resets), static_cast<const T*>(wpk), static_cast<const T*>(bh),
                             static_cast<float*>(outs), static_cast<float*>(s_final), steps, B, H, BT);
    if (err != cudaSuccess) return failed(err);
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

// ------------------------------------------------------------------ design "grid" (LSTM, f32)

// Most threads of a grid-design block with TM x TN accumulators a thread: 512 with 16 (at most
// 128 registers a thread), 256 with 64 (at most 255: the tile and its operands stay in registers).
__host__ __device__ constexpr int grid_max_threads(int TM, int TN) { return TM * TN >= 64 ? 256 : 512; }

// Threads of a grid-design block: KS splits of K x the row tiles of one pass (BT / passes / TM) x
// 4U/TN column tiles. A block covers its BT rows in `passes` passes of the same threads.
__host__ __device__ constexpr int grid_threads(int U, int BT, int TM, int TN, int KS, int passes) {
    return KS * (BT / passes / TM) * (4 * U / TN);
}

// Dynamic shared memory of one grid-design block; ops/cuda_rnn.py:grid_smem is the same formula:
// the wh slice [H][4U], a pass's h chunks [stages][BT/passes][KC+4] (one stage where the chunk is
// all of H, else two), the K splits' partial sums [threads][TM*TN].
inline size_t grid_smem_bytes(int H, int U, int BT, int TM, int TN, int KS, int KC, int passes) {
    const size_t stages = KC == H ? 1 : 2;
    const size_t partials = KS > 1 ? static_cast<size_t>(grid_threads(U, BT, TM, TN, KS, passes)) * TM * TN : 0;
    return 4 * (static_cast<size_t>(H) * 4 * U + stages * (BT / passes) * (KC + 4) + partials);
}

__device__ __forceinline__ void prefetch_l2(const void* p) { asm volatile("prefetch.global.L2 [%0];" ::"l"(p)); }

// V neighbouring floats in one access (V = 1, 2 or 4; the address is a multiple of 4V bytes)
template <int V>
__device__ __forceinline__ void load_v(float (&d)[V], const float* p) {
    if constexpr (V == 4) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
    } else if constexpr (V == 2) {
        const float2 v = *reinterpret_cast<const float2*>(p);
        d[0] = v.x, d[1] = v.y;
    } else {
        d[0] = *p;
    }
}
template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&d)[V]) {
    if constexpr (V == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(d[0], d[1], d[2], d[3]);
    } else if constexpr (V == 2) {
        *reinterpret_cast<float2*>(p) = make_float2(d[0], d[1]);
    } else {
        *p = d[0];
    }
}

// V neighbouring cells (batch row b, hidden units col .. col + V - 1) at step t, of an LSTM
// (LstmCells) or a GRU (GruCells): the cell policy of the grid kernel. G is the gates of x_proj
// and wh, SW the state row's width in H (s0 and s_final are [B][SW*H]). The inputs are loaded apart
// from the math (`load`, then `step`), so that a thread issues them before it waits on them: ahead
// of the product where a thread owns one cell, a row ahead where it owns a register tile's cells.
// `step` takes the gate sums a[g][v] = h @ wh (f32) and writes outs[t], the new carry into the next
// h buffer (read by every block after the grid barrier) and at the last step the carry into s_final.

// LSTM: the cell state lives in s_final's c half, read and written by the cells' one owning thread.
template <int V>
struct LstmCells {
    static constexpr int G = 4, SW = 2;
    struct Bias {  // none: bi is folded into x_proj
        __device__ __forceinline__ void load(const float*, int, int) {}
    };
    float x[4][V];  // step t's x_proj of the four gates
    float c[V];     // the cell states entering step t
    float reset;    // resets[t][b]

    __device__ __forceinline__ void load(const float* __restrict__ xs, const float* __restrict__ resets, const float*,
                                         const float* hc, int t, int B, int H, int b, int col) {
        const float* xp = xs + ((size_t)t * B + b) * 4 * H + col;
#pragma unroll
        for (int g = 0; g < 4; ++g) load_v<V>(x[g], xp + g * H);
        load_v<V>(c, hc + (size_t)b * 2 * H + H + col);
        reset = resets[(size_t)t * B + b];
    }

    __device__ __forceinline__ void step(const float (&a)[4][V], const Bias&, float* h_next, float* __restrict__ outs,
                                         float* hc, int t, int B, int H, int b, int col, bool last) const {
        const bool keep = !(reset > 0.0f);
        float h[V], carry[V], cell[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
            const float pi = add<float>(x[0][v], a[0][v]), pf = add<float>(x[1][v], a[1][v]);
            const float pg = add<float>(x[2][v], a[2][v]), po = add<float>(x[3][v], a[3][v]);
            const float new_c = add<float>(mul<float>(sigmoid_t<float>(add<float>(pf, 1.0f)), c[v]),
                                           mul<float>(sigmoid_t<float>(pi), tanh_t<float>(pg)));
            h[v] = mul<float>(sigmoid_t<float>(po), tanh_t<float>(new_c));
            carry[v] = keep ? h[v] : 0.0f;
            cell[v] = keep ? new_c : 0.0f;
        }
        store_v<V>(outs + ((size_t)t * B + b) * H + col, h);
        store_v<V>(h_next + (size_t)b * H + col, carry);
        store_v<V>(hc + (size_t)b * 2 * H + H + col, cell);
        if (last) store_v<V>(hc + (size_t)b * 2 * H + col, carry);
    }
};

// GRU: bh is added to the sums before the gates (held in registers for all T steps), and the old h
// of `z * h` is the carry that this thread itself wrote into the h buffer at step t - 1 (after the
// reset; h0 at step 0, written before the first grid barrier), read back from there.
template <int V>
struct GruCells {
    static constexpr int G = 3, SW = 1;
    struct Bias {
        float b[3][V];
        __device__ __forceinline__ void load(const float* __restrict__ bh, int H, int col) {
#pragma unroll
            for (int g = 0; g < 3; ++g) load_v<V>(b[g], bh + g * H + col);
        }
    };
    float x[3][V];  // step t's x_proj of the three gates
    float h[V];     // the carry entering step t
    float reset;

    __device__ __forceinline__ void load(const float* __restrict__ xs, const float* __restrict__ resets, const float* h_cur,
                                         const float*, int t, int B, int H, int b, int col) {
        const float* xp = xs + ((size_t)t * B + b) * 3 * H + col;
#pragma unroll
        for (int g = 0; g < 3; ++g) load_v<V>(x[g], xp + g * H);
        load_v<V>(h, h_cur + (size_t)b * H + col);
        reset = resets[(size_t)t * B + b];
    }

    __device__ __forceinline__ void step(const float (&a)[3][V], const Bias& bias, float* h_next, float* __restrict__ outs,
                                         float* s, int t, int B, int H, int b, int col, bool last) const {
        const bool keep = !(reset > 0.0f);
        float out[V], carry[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
            const float hr = add<float>(a[0][v], bias.b[0][v]), hz = add<float>(a[1][v], bias.b[1][v]);
            const float hn = add<float>(a[2][v], bias.b[2][v]);
            const float rg = sigmoid_t<float>(add<float>(x[0][v], hr));
            const float zg = sigmoid_t<float>(add<float>(x[1][v], hz));
            const float n = tanh_t<float>(add<float>(x[2][v], mul<float>(rg, hn)));
            out[v] = add<float>(mul<float>(sub<float>(1.0f, zg), n), mul<float>(zg, h[v]));
            carry[v] = keep ? out[v] : 0.0f;
        }
        store_v<V>(outs + ((size_t)t * B + b) * H + col, out);
        store_v<V>(h_next + (size_t)b * H + col, carry);
        if (last) store_v<V>(s + (size_t)b * H + col, carry);
    }
};

// A persistent cooperative grid of Q batch tiles x S unit slices (blockIdx = tile * S + slice).
// A thread holds TM x TN accumulators: TM rows (p0 + rt + i * RT in the pass from tile row p0) x
// V = TN/4 units (ct * V + v) x 4 gate columns. The GRU's three gates take the LSTM's tiles with a
// fourth gate of zero columns in the shared-memory slice: a thread's FMAs run in parallel with its
// neighbours', so the wasted quarter costs issue slots, not the latency that sets a step at small B.
// Where K is split (KS > 1: one pass, at most as many cells as threads) thread tid owns cell tid:
// it loads the cell's inputs before the product and applies it after the splits' sum.
template <template <int> class Cells, int TM, int TN>
__global__ void __launch_bounds__(grid_max_threads(TM, TN), 1)
    grid_kernel(const float* __restrict__ x, const float* __restrict__ s0, const float* __restrict__ resets,
                const float* __restrict__ wpk, const float* __restrict__ bh, float* hbuf, float* __restrict__ outs,
                float* s_final, int steps, int B, int H, int U, int BT, int KS, int KC, int passes) {
    constexpr int V = TN / 4;  // units a thread: V units x 4 gate columns = TN accumulator columns
    constexpr int G = Cells<1>::G, SW = Cells<1>::SW;
    cg::grid_group grid = cg::this_grid();
    const int S = H / U, N = 4 * U, NCT = U / V, PR = BT / passes, RT = PR / TM, tiles = RT * NCT;
    const int r = static_cast<int>(blockIdx.x) % S, b0 = static_cast<int>(blockIdx.x) / S * BT;
    const int tid = threadIdx.x, threads = blockDim.x;
    const int ct = tid % NCT, rt = tid / NCT % RT, ks = tid / tiles;  // tid = (ks * RT + rt) * NCT + ct
    const int rows = min(BT, B - b0);                                   // live rows of this tile
    const int HS = KC + 4, stages = KC == H ? 1 : 2, L = KC / KS, chunks = H / KC;
    const bool own_cell = KS > 1 && tid < rows * U;
    const int cell_row = tid / U, cell_col = r * U + tid % U;

    extern __shared__ __align__(16) unsigned char smem[];
    float* w_s = reinterpret_cast<float*>(smem);  // [H][N]: this block's gate columns, permuted (below)
    float* h_s = w_s + H * N;                     // [stages][PR][HS]: chunks of a pass's carry h, K contiguous
    float* red = h_s + stages * PR * HS;          // [KS][tiles][TM * TN]: partial sums of the K splits

    // The wh slice, once: pack_wh's rows g*U + u (K contiguous; G*U of them) become columns, ordered so
    // that a thread's TN columns are V float4 at p = jh * 4 * NCT + ct * 4 + e (j = 4 * jh + e = g * V + v),
    // and a warp's loads of one k read neighbouring 16-byte words; a GRU's fourth gate is zero.
    for (int i = tid; i < N * (H / 4); i += threads) {
        const int p = i % N, k = i / N * 4;
        const int jh = p / (4 * NCT), c = p % (4 * NCT) / 4, j = jh * 4 + (p & 3);
        const int g = j / V, u = c * V + j % V;
        const float4 w = g < G ? *reinterpret_cast<const float4*>(wpk + ((size_t)r * G * U + g * U + u) * H + k)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        w_s[k * N + p] = w.x;
        w_s[(k + 1) * N + p] = w.y;
        w_s[(k + 2) * N + p] = w.z;
        w_s[(k + 3) * N + p] = w.w;
    }
    for (int i = tid; i < stages * PR * HS; i += threads) h_s[i] = 0.0f;  // rows past B stay zero
    // h0 into the first h buffer, and the tile's initial state into s_final (the LSTM's c half holds
    // the cell state from here on)
    for (int i = tid; i < rows * U; i += threads) {
        const int b = b0 + i / U, col = r * U + i % U;
        hbuf[(size_t)b * H + col] = s0[(size_t)b * SW * H + col];
#pragma unroll
        for (int part = 0; part < SW; ++part) s_final[(size_t)b * SW * H + part * H + col] = s0[(size_t)b * SW * H + part * H + col];
    }
    // the biases of this thread's cells, for all T steps: the one it owns where K is split, else its
    // register tile's V units
    typename Cells<1>::Bias own_bias;
    typename Cells<V>::Bias tile_bias;
    if (own_cell) own_bias.load(bh, H, cell_col);
    if (KS == 1) tile_bias.load(bh, H, r * U + ct * V);
    // step t's x_proj slice (one line a row and gate: U floats) and resets into L2
    auto prefetch_step = [&](int t) {
        for (int i = tid; i < rows * G; i += threads) prefetch_l2(x + ((size_t)t * B + b0 + i / G) * G * H + (i % G) * H + r * U);
        for (int i = tid * 32; i < rows; i += threads * 32) prefetch_l2(resets + (size_t)t * B + b0 + i);
    };
    prefetch_step(0);
    grid.sync();  // every block holds its wh slice; h0 is in the first buffer

    for (int t = 0; t < steps; ++t) {
        PHASE_MARK(c0);
        const float* h_cur = hbuf + (size_t)(t & 1) * B * H;
        float* h_next = hbuf + (size_t)((t + 1) & 1) * B * H;
        const bool last = t + 1 == steps;
        if (!last) prefetch_step(t + 1);
        Cells<1> mine;
        if (own_cell) mine.load(x, resets, h_cur, s_final, t, B, H, b0 + cell_row, cell_col);
        PHASE_MARK(c1);

        for (int pass = 0; pass < passes; ++pass) {
            const int p0 = pass * PR, prows = min(PR, rows - p0);
            if (prows <= 0) break;
            PHASE_MARK(q0);
            // chunk c of the pass's h: prows x KC, 16-byte copies through L2 only (cp.async.cg), so
            // that no line of an earlier step is read from L1
            auto load_chunk = [&](int c) {
                float* dst = h_s + (c & 1) * PR * HS;
                const int pieces = KC / 4;
                for (int i = tid; i < prows * pieces; i += threads) {
                    const int row = i / pieces, k = i % pieces * 4;
                    cp_async16(dst + row * HS + k, h_cur + (size_t)(b0 + p0 + row) * H + c * KC + k);
                }
                cp_async_commit();
            };
            float acc[TM][TN];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
            // two stages where the chunk is not all of H: chunk c + 1 loads while chunk c is multiplied
            load_chunk(0);
            for (int c = 0; c < chunks; ++c) {
                if (c + 1 < chunks) {
                    load_chunk(c + 1);
                    cp_async_wait<1>();
                } else {
                    cp_async_wait<0>();
                }
                __syncthreads();
                // this thread's split of the chunk: K from c * KC + ks * L, L long; the h of its rows
                // and the wh of its columns for 4 k are loaded before their products
                const float* hs = h_s + (c & 1) * PR * HS + ks * L;
                const float* ws = w_s + (size_t)(c * KC + ks * L) * N + ct * 4;
                for (int kk = 0; kk < L; kk += 4) {
                    float4 a[TM], w[4][V];
#pragma unroll
                    for (int i = 0; i < TM; ++i) a[i] = *reinterpret_cast<const float4*>(hs + (rt + i * RT) * HS + kk);
#pragma unroll
                    for (int e = 0; e < 4; ++e)
#pragma unroll
                        for (int jh = 0; jh < V; ++jh) w[e][jh] = *reinterpret_cast<const float4*>(ws + (kk + e) * N + jh * 4 * NCT);
#pragma unroll
                    for (int e = 0; e < 4; ++e)
#pragma unroll
                        for (int i = 0; i < TM; ++i) {
                            const float hv = e == 0 ? a[i].x : e == 1 ? a[i].y : e == 2 ? a[i].z : a[i].w;
#pragma unroll
                            for (int jh = 0; jh < V; ++jh) {
                                acc[i][4 * jh] = fmaf(hv, w[e][jh].x, acc[i][4 * jh]);
                                acc[i][4 * jh + 1] = fmaf(hv, w[e][jh].y, acc[i][4 * jh + 1]);
                                acc[i][4 * jh + 2] = fmaf(hv, w[e][jh].z, acc[i][4 * jh + 2]);
                                acc[i][4 * jh + 3] = fmaf(hv, w[e][jh].w, acc[i][4 * jh + 3]);
                            }
                        }
                }
                __syncthreads();  // the stage is free for chunk c + 2 (or the next pass)
            }
            PHASE_MARK(q1);

            if (KS > 1) {
                // the splits' partial sums through shared memory; each cell adds its gates'
                float* part = red + (size_t)tid * TM * TN;
#pragma unroll
                for (int i = 0; i < TM; ++i)
#pragma unroll
                    for (int j = 0; j < TN; j += 4)
                        *reinterpret_cast<float4*>(part + i * TN + j) = make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
                __syncthreads();
                if (own_cell) {
                    const int u = tid % U;
                    const float* p = red + (size_t)(cell_row % RT * NCT + u / V) * TM * TN + cell_row / RT * TN + u % V;
                    float a[G][1] = {};
#pragma unroll 4
                    for (int s = 0; s < KS; ++s)
#pragma unroll
                        for (int g = 0; g < G; ++g) a[g][0] += p[(size_t)s * tiles * TM * TN + g * V];
                    mine.step(a, own_bias, h_next, outs, s_final, t, B, H, b0 + cell_row, cell_col, last);
                }
            } else {
                // row by row, the next row's inputs loaded before this row's cells are applied
                const int col = r * U + ct * V;
                Cells<V> cells[2];
                if (p0 + rt < rows) cells[0].load(x, resets, h_cur, s_final, t, B, H, b0 + p0 + rt, col);
#pragma unroll
                for (int i = 0; i < TM; ++i) {
                    const int row = p0 + rt + i * RT;
                    if (i + 1 < TM && row + RT < rows) cells[(i + 1) & 1].load(x, resets, h_cur, s_final, t, B, H, b0 + row + RT, col);
                    if (row < rows) {
                        float a[G][V];
#pragma unroll
                        for (int g = 0; g < G; ++g)
#pragma unroll
                            for (int v = 0; v < V; ++v) a[g][v] = acc[i][g * V + v];
                        cells[i & 1].step(a, tile_bias, h_next, outs, s_final, t, B, H, b0 + row, col, last);
                    }
                }
            }
            PHASE_MARK(q2);
            PHASE_ADD(0, q0, q1);  // the h loads and the product
            PHASE_ADD(1, q1, q2);  // the splits' sums and the cells
        }
        PHASE_MARK(c3);
        if (!last) grid.sync();  // the new carry is in L2 for every block; this step's buffers are free
        PHASE_MARK(c4);
        PHASE_ADD(2, c0, c1);  // the next step's prefetch and the split path's input loads
        PHASE_ADD(3, c3, c4);  // the grid barrier
    }
}

template <template <int> class Cells, int TM, int TN>
int launch_grid(const void* x, const void* s0, const void* resets, const void* wpk, const void* bh, void* hbuf, void* outs,
                void* s_final, int steps, int B, int H, int U, int BT, int KS, int KC, int passes, int threads, int smem,
                cudaStream_t stream) {
    if (U < TN / 4 || U % (TN / 4) != 0 || H % U != 0 || passes < 1 || BT % (passes * TM) != 0 || KS < 1 || KC < 4 ||
        H % KC != 0 || KC % (4 * KS) != 0 || threads != grid_threads(U, BT, TM, TN, KS, passes) ||
        threads > grid_max_threads(TM, TN) || (KS > 1 && (passes > 1 || BT * U > threads)) ||
        (size_t)smem != grid_smem_bytes(H, U, BT, TM, TN, KS, KC, passes))
        return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = grid_kernel<Cells, TM, TN>;
    const int grid = (B + BT - 1) / BT * (H / U);

    // The shared-memory limit and the check that the whole grid is resident at once, once per
    // configuration, device and process; a cooperative launch that does not fit is refused.
    static std::mutex lock;
    static std::map<int, int> smem_set;                                // device -> the limit set there
    static std::set<std::pair<int, std::pair<int, int>>> checked;  // (device, (threads, smem))
    cudaError_t err = cudaSuccess;
    {
        std::lock_guard<std::mutex> guard(lock);
        int dev = 0;
        err = cudaGetDevice(&dev);
        if (err != cudaSuccess) return failed(err);
        if (smem > smem_set[dev]) {
            err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (err != cudaSuccess) return failed(err);
            smem_set[dev] = smem;
        }
        if (!checked.count({dev, {threads, smem}})) {
            int per_sm = 0, sms = 0;
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
            if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
            if (err != cudaSuccess) return failed(err);
            if (per_sm * sms < grid) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
            checked.insert({dev, {threads, smem}});
        }
    }
    const float* xf = static_cast<const float*>(x);
    const float* s0f = static_cast<const float*>(s0);
    const float* rf = static_cast<const float*>(resets);
    const float* wf = static_cast<const float*>(wpk);
    const float* bf = static_cast<const float*>(bh);
    float* hb = static_cast<float*>(hbuf);
    float* of = static_cast<float*>(outs);
    float* sf = static_cast<float*>(s_final);
    void* args[] = {&xf, &s0f, &rf, &wf, &bf, &hb, &of, &sf, &steps, &B, &H, &U, &BT, &KS, &KC, &passes};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid), dim3(threads), args, smem, stream);
    if (err != cudaSuccess) return failed(err);
    return static_cast<int>(cudaGetLastError());
}

template <template <int> class Cells>
int grid_forward(const void* x, const void* s0, const void* resets, const void* wpk, const void* bh, void* hbuf, void* outs,
                 void* s_final, int steps, int B, int H, int units, int rows, int tile_rows, int tile_cols, int ksplit,
                 int kchunk, int passes, int threads, int smem, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (tile_rows == 4 && tile_cols == 4)
        return launch_grid<Cells, 4, 4>(x, s0, resets, wpk, bh, hbuf, outs, s_final, steps, B, H, units, rows, ksplit, kchunk,
                                        passes, threads, smem, s);
    if (tile_rows == 8 && tile_cols == 8)
        return launch_grid<Cells, 8, 8>(x, s0, resets, wpk, bh, hbuf, outs, s_final, steps, B, H, units, rows, ksplit, kchunk,
                                        passes, threads, smem, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------------------------ backward (BPTT): the row design, mirrored

constexpr int kBwdThreads = 256;  // most threads of a backward block (block_threads(H))

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// Dynamic shared memory of one backward block of R rows; ops/cuda_rnn.py:bwd_smem is the same formula.
// f32: dh [R][H], dc [R][H] (LSTM), the step's gate cotangents dg [R][G*H]; the stage of the next step's
// inputs: x_proj (GRU) or proj (LSTM) [R][G*H] in T, h_proj [R][G*H] in T (GRU), h_prev (GRU) or c
// (LSTM) [R][H] f32, d_outs [R][H] f32, resets [R] f32. Each part starts on 16 bytes.
inline size_t bwd_smem_bytes(int G, int H, int R, int elem) {
    const size_t RH = static_cast<size_t>(R) * H, RGH = RH * G;
    const size_t parts = G == 4 ? 2 : 1;
    return parts * align16(4 * RH) + align16(4 * RGH) + (G == 3 ? 2 : 1) * align16(elem * RGH) + 2 * align16(4 * RH) +
           align16(4 * static_cast<size_t>(R));
}

template <typename T>
struct BwdArgs {
    const float* d_outs;   // [steps][B][H]
    const float* d_final;  // the final state's cotangent [B][SW*H]
    const float* resets;   // [steps][B]
    const T* a;            // GRU: x_proj, LSTM: proj = x_proj + h_prev @ wh, [steps][B][G*H]
    const T* hp;           // GRU: h_proj = h_prev @ wh + bh [steps][B][G*H]; LSTM: unused
    const float* s;        // GRU: h_prev, the carry entering each step [steps][B][H]; LSTM: hc0 [B][2H]
    const T* wt;           // wh transposed, [G*H][H] (the row design); wh as given, [H][G*H] (the grid design)
    float* cbuf;           // LSTM: the cell state entering each step [steps][B][H] (scratch); GRU: unused
    T* da;                 // d_x_proj [steps][B][G*H]
    T* dhn;                // GRU: d_hn = da_n * r [steps][B][H]; LSTM: unused (d_x_proj is the product's gradient)
    float* d_state0;       // d_h0 [B][H] or d_hc0 [B][2H] (the grid design also carries its cells' cotangents there)
    int steps, B, H;
    bool cells_given;      // the resident LSTM: cbuf holds the cell states the forward saved, and its pass is skipped
};

// The gate s = 1 / (1 + e), e = exp(-max(x, -88)), each op rounded to T as the plain version's `_sigmoid`
// rounds it, and its derivative e * s * s; 0 below -88, as the clamp's backward gives it (fault C6: e * s * s
// there would be inf * 0).
struct Sig {
    float s, ds;
};
template <typename T>
__device__ __forceinline__ Sig sig_bwd(float x) {
    const float e = Num<T>::round(expf(-(x < -88.0f ? -88.0f : x)));
    const float s = Num<T>::round(__fdiv_rn(1.0f, add<T>(1.0f, e)));
    return {s, x < -88.0f ? 0.0f : e * s * s};
}

// nbytes from global src into shared dst (16-byte aligned), asynchronously where the source allows it:
// cp.async of 16 bytes, else of 4; a bf16 range at an odd element offset is copied by plain loads.
// The condition is the same for every thread of the block.
__device__ __forceinline__ void stage_copy(void* dst, const void* src, int nbytes) {
    char* d = static_cast<char*>(dst);
    const char* s = static_cast<const char*>(src);
    const int tid = threadIdx.x, nt = blockDim.x;
    const uintptr_t how = reinterpret_cast<uintptr_t>(s) | static_cast<uintptr_t>(nbytes);
    if ((how & 15) == 0) {
        for (int i = tid * 16; i < nbytes; i += nt * 16) cp_async16(d + i, s + i);
    } else if ((how & 3) == 0) {
        for (int i = tid * 4; i < nbytes; i += nt * 4) cp_async4(d + i, s + i);
    } else {
        for (int i = tid * 2; i < nbytes; i += nt * 2) *reinterpret_cast<uint16_t*>(d + i) = *reinterpret_cast<const uint16_t*>(s + i);
    }
}

// One block owns R batch rows [b0, b0 + R) and all H units, and runs every step in reverse (G = 3: the GRU,
// 4: the LSTM). Per step t: wait for step t's staged inputs; each (row, unit) cell takes the cotangent of
// its new state (d_outs[t], plus the carried one unless resets[t] > 0), recomputes its gates from the
// staged pre-activations in T, writes d_x_proj[t] (and the GRU's d_hn[t]) and its gate cotangents into dg;
// barrier; the copies of step t-1's inputs start; then dh = dg @ wh^T (+ g * z for the GRU), thread k
// owning unit k of every row, reading the k-th column of wh^T, neighbouring threads on neighbouring
// addresses, from L2. The LSTM first recomputes the cell state entering each step, forward in time, into
// cbuf: the forward saves h (its outputs), not c.
template <typename T, int G, int R>
__global__ void __launch_bounds__(kBwdThreads) seq_bwd_kernel(const BwdArgs<T> p) {
    constexpr bool kLstm = G == 4;
    constexpr int SW = kLstm ? 2 : 1;
    const int H = p.H, GH = G * H, B = p.B, RH = R * H;
    const int b0 = static_cast<int>(blockIdx.x) * R, live = min(R, B - b0);
    const int tid = threadIdx.x, nt = blockDim.x;

    extern __shared__ __align__(16) unsigned char bwd_smem[];
    unsigned char* cur = bwd_smem;
    auto take = [&](size_t bytes) {
        unsigned char* at = cur;
        cur += align16(bytes);
        return at;
    };
    float* dh = reinterpret_cast<float*>(take(4 * (size_t)RH));
    float* dc = kLstm ? reinterpret_cast<float*>(take(4 * (size_t)RH)) : nullptr;
    float* dg = reinterpret_cast<float*>(take(4 * (size_t)R * GH));
    T* sa = reinterpret_cast<T*>(take(sizeof(T) * (size_t)R * GH));
    T* shp = kLstm ? nullptr : reinterpret_cast<T*>(take(sizeof(T) * (size_t)R * GH));
    float* sv = reinterpret_cast<float*>(take(4 * (size_t)RH));  // h_prev (GRU) or c (LSTM) of the step
    float* sd = reinterpret_cast<float*>(take(4 * (size_t)RH));  // d_outs of the step
    float* sr = reinterpret_cast<float*>(take(4 * (size_t)R));   // resets of the step

    // rows past B stay zero in dh, dc and dg, so the product over all R rows stays finite
    for (int i = tid; i < RH; i += nt) {
        const int r = i / H, j = i - r * H;
        const bool in = r < live;
        dh[i] = in ? p.d_final[(size_t)(b0 + r) * SW * H + j] : 0.0f;
        if constexpr (kLstm) dc[i] = in ? p.d_final[(size_t)(b0 + r) * 2 * H + H + j] : 0.0f;
    }
    for (int i = tid; i < R * GH; i += nt) dg[i] = 0.0f;

    if constexpr (kLstm) {
        // the cell state entering step t, as the forward computed it (sv holds it, each cell its own thread's)
        for (int i = tid; i < live * H; i += nt) {
            const int r = i / H, j = i - r * H;
            sv[i] = Num<T>::round(p.s[(size_t)(b0 + r) * 2 * H + H + j]);
        }
        for (int t = 0; t < p.steps; ++t) {
            for (int i = tid; i < live * H; i += nt) {
                const int r = i / H, j = i - r * H;
                const size_t row = (size_t)t * B + b0 + r;
                const float c = sv[i];
                p.cbuf[row * H + j] = c;
                const T* pr = p.a + row * GH + j;
                const float pi = Num<T>::load(pr), pf = Num<T>::load(pr + H), pg = Num<T>::load(pr + 2 * H);
                const float new_c = add<T>(mul<T>(sig_bwd<T>(add<T>(pf, 1.0f)).s, c), mul<T>(sig_bwd<T>(pi).s, tanh_t<T>(pg)));
                sv[i] = p.resets[row] > 0.0f ? 0.0f : new_c;
            }
        }
        __syncthreads();  // cbuf, written by this block's threads, is read by the stage copies below
    }

    auto stage = [&](int t) {
        const size_t row = (size_t)t * B + b0;
        stage_copy(sa, p.a + row * GH, static_cast<int>(sizeof(T)) * live * GH);
        if constexpr (!kLstm) stage_copy(shp, p.hp + row * GH, static_cast<int>(sizeof(T)) * live * GH);
        stage_copy(sv, (kLstm ? p.cbuf : p.s) + row * H, 4 * live * H);
        stage_copy(sd, p.d_outs + row * H, 4 * live * H);
        stage_copy(sr, p.resets + row, 4 * live);
        cp_async_commit();
    };
    stage(p.steps - 1);

    for (int t = p.steps - 1; t >= 0; --t) {
        cp_async_wait<0>();
        __syncthreads();  // step t's inputs have landed; dh of the product of step t + 1 is written
        for (int i = tid; i < live * H; i += nt) {
            const int r = i / H, j = i - r * H;
            const size_t o = ((size_t)t * B + b0 + r) * GH + j;
            const T* a = sa + r * GH + j;
            float* g_out = dg + r * GH + j;
            const bool keep = !(sr[r] > 0.0f);
            if constexpr (kLstm) {
                const float pi = Num<T>::load(a), pf = Num<T>::load(a + H), pg = Num<T>::load(a + 2 * H), po = Num<T>::load(a + 3 * H);
                const float fa = add<T>(pf, 1.0f);
                const Sig si = sig_bwd<T>(pi), sf = sig_bwd<T>(fa), so = sig_bwd<T>(po);
                const float tg = tanh_t<T>(pg), c = sv[i];
                const float tc = tanh_t<T>(add<T>(mul<T>(sf.s, c), mul<T>(si.s, tg)));
                const float gh = sd[i] + (keep ? dh[i] : 0.0f), gc = keep ? dc[i] : 0.0f;
                const float dct = gc + gh * so.s * (1.0f - tc * tc);
                const float dai = dct * tg * si.ds, daf = dct * c * sf.ds, dag = dct * si.s * (1.0f - tg * tg), dao = gh * tc * so.ds;
                dc[i] = dct * sf.s;
                p.da[o] = Num<T>::to(dai), p.da[o + H] = Num<T>::to(daf), p.da[o + 2 * H] = Num<T>::to(dag), p.da[o + 3 * H] = Num<T>::to(dao);
                g_out[0] = dai, g_out[H] = daf, g_out[2 * H] = dag, g_out[3 * H] = dao;
            } else {
                const T* hp = shp + r * GH + j;
                const float hn = Num<T>::load(hp + 2 * H);
                const Sig rg = sig_bwd<T>(add<T>(Num<T>::load(a), Num<T>::load(hp)));
                const Sig zg = sig_bwd<T>(add<T>(Num<T>::load(a + H), Num<T>::load(hp + H)));
                const float n = tanh_t<T>(add<T>(Num<T>::load(a + 2 * H), mul<T>(rg.s, hn)));
                const float h = Num<T>::round(sv[i]);
                const float g = sd[i] + (keep ? dh[i] : 0.0f);
                const float dan = g * (1.0f - zg.s) * (1.0f - n * n);
                const float dar = dan * hn * rg.ds, daz = g * (h - n) * zg.ds, dhn = dan * rg.s;
                dh[i] = g * zg.s;  // the direct term of dh_prev; the product adds d_h_proj @ wh^T
                p.da[o] = Num<T>::to(dar), p.da[o + H] = Num<T>::to(daz), p.da[o + 2 * H] = Num<T>::to(dan);
                p.dhn[((size_t)t * B + b0 + r) * H + j] = Num<T>::to(dhn);
                g_out[0] = dar, g_out[H] = daz, g_out[2 * H] = dhn;
            }
        }
        __syncthreads();  // dg is whole; the stage is free
        if (t > 0) stage(t - 1);
        for (int k = tid; k < H; k += nt) {
            float acc[R];
#pragma unroll
            for (int r = 0; r < R; ++r) acc[r] = 0.0f;
            const T* w = p.wt + k;
#pragma unroll 4
            for (int c = 0; c < GH; ++c) {
                const float wv = Num<T>::load(w + (size_t)c * H);
#pragma unroll
                for (int r = 0; r < R; ++r) acc[r] = fmaf(dg[r * GH + c], wv, acc[r]);
            }
#pragma unroll
            for (int r = 0; r < R; ++r)
                if (r < live) dh[r * H + k] = kLstm ? acc[r] : dh[r * H + k] + acc[r];
        }
    }
    __syncthreads();
    for (int i = tid; i < live * H; i += nt) {
        const int r = i / H, j = i - r * H;
        p.d_state0[(size_t)(b0 + r) * SW * H + j] = dh[i];
        if constexpr (kLstm) p.d_state0[(size_t)(b0 + r) * 2 * H + H + j] = dc[i];
    }
}

template <typename T, int G, int R>
int launch_bwd(const BwdArgs<T>& p, int smem, cudaStream_t stream) {
    auto kernel = seq_bwd_kernel<T, G, R>;
    // the shared-memory limit above 48 KB, once per device and process (as launch_cluster sets it)
    static std::mutex lock;
    static std::map<int, int> smem_set;  // device -> the limit set there
    {
        std::lock_guard<std::mutex> guard(lock);
        int dev = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err != cudaSuccess) return failed(err);
        if (smem > 48 * 1024 && smem > smem_set[dev]) {
            err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (err != cudaSuccess) return failed(err);
            smem_set[dev] = smem;
        }
    }
    kernel<<<(p.B + R - 1) / R, block_threads(p.H), smem, stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int G>
int seq_backward(const BwdArgs<T>& p, int rows, int smem, cudaStream_t stream) {
    if (p.steps < 1 || p.B < 1 || p.H < 1 || p.H > 1024 || rows < 1 || (size_t)smem != bwd_smem_bytes(G, p.H, rows, sizeof(T)))
        return static_cast<int>(cudaErrorInvalidValue);
    switch (rows) {
        case 1: return launch_bwd<T, G, 1>(p, smem, stream);
        case 2: return launch_bwd<T, G, 2>(p, smem, stream);
        case 4: return launch_bwd<T, G, 4>(p, smem, stream);
        case 8: return launch_bwd<T, G, 8>(p, smem, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

template <int G>
int seq_backward_typed(const void* d_outs, const void* d_final, const void* resets, const void* a, const void* hp, const void* s,
                       const void* wt, void* cbuf, void* da, void* dhn, void* d_state0, int steps, int B, int H, int is_bf16,
                       int rows, int smem, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    auto args = [&](auto* typed) {
        using T = std::remove_const_t<std::remove_pointer_t<decltype(typed)>>;
        return BwdArgs<T>{static_cast<const float*>(d_outs), static_cast<const float*>(d_final), static_cast<const float*>(resets),
                          static_cast<const T*>(a), static_cast<const T*>(hp), static_cast<const float*>(s),
                          static_cast<const T*>(wt), static_cast<float*>(cbuf), static_cast<T*>(da), static_cast<T*>(dhn),
                          static_cast<float*>(d_state0), steps, B, H};
    };
    if (is_bf16) return seq_backward<__nv_bfloat16, G>(args(static_cast<__nv_bfloat16*>(nullptr)), rows, smem, st);
    return seq_backward<float, G>(args(static_cast<float*>(nullptr)), rows, smem, st);
}

// ------------------------------------------------------------------ backward (BPTT): the grid design (float32)

constexpr int kBwdGridThreads = 512;  // most threads of a grid backward block (4 x 4 accumulators a thread)

// Threads of a grid backward block: KS splits of K x the 4 x 4 register tiles of one pass (BT / passes / 4 rows x
// U / 4 units).
__host__ __device__ constexpr int bwd_grid_threads(int U, int BT, int KS, int passes) { return KS * (BT / passes / 4) * (U / 4); }

// Dynamic shared memory of one grid backward block; ops/cuda_rnn.py:bwd_grid_smem is the same formula: the rows of wh
// of the block's units, transposed, [G*H][U]; a pass's chunks of the gate cotangents [2][BT/passes][KC+4] (the next
// chunk loads while this one is multiplied; a row's pad of 4 floats puts the float4 reads of 8 neighbouring rows on 8
// bank groups); where K is split, every thread's partial sums [threads][16].
inline size_t bwd_grid_smem_bytes(int G, int H, int U, int BT, int KS, int KC, int passes) {
    const size_t partials = KS > 1 ? static_cast<size_t>(bwd_grid_threads(U, BT, KS, passes)) * 16 : 0;
    return 4 * (static_cast<size_t>(G) * H * U + 2 * static_cast<size_t>(BT / passes) * (KC + 4) + partials);
}

// V neighbouring cells (batch row b, hidden units col .. col + V - 1) of the backward at step t, of an LSTM
// (LstmBwdCells) or a GRU (GruBwdCells): the cell policy of the grid backward kernel. `load` reads step t's inputs of
// the cells (t = -1: only the direct term, for the final state's cotangent); `step` takes the product
// prod[v] = (d_h_proj[t + 1] @ wh^T)[b][col + v] and writes d_x_proj[t] (and the GRU's d_hn[t]), which the other
// blocks read after the grid barrier, and the cells' carried cotangents. Those live in d_state0, read and written
// by the cells' one owning thread: its h half holds the direct term of dh (the GRU's g * z; 0 for the LSTM), its c
// half the LSTM's dc; both start as the final state's cotangent, and the h half ends as direct + product.

template <int V>
struct LstmBwdCells {
    static constexpr int G = 4, SW = 2;
    float a[4][V];  // proj[t], the four gates' pre-activations
    float c[V];     // the cell state entering step t (cbuf)
    float d[V];     // d_outs[t]
    float dh0[V];   // the direct term of the carried dh
    float dc[V];    // the carried dc
    float reset;

    __device__ __forceinline__ void load(const BwdArgs<float>& p, int t, int b, int col) {
        const int H = p.H;
        load_v<V>(dh0, p.d_state0 + (size_t)b * 2 * H + col);
        if (t < 0) return;
        const size_t row = (size_t)t * p.B + b;
#pragma unroll
        for (int g = 0; g < 4; ++g) load_v<V>(a[g], p.a + row * 4 * H + g * H + col);
        load_v<V>(c, p.cbuf + row * H + col);
        load_v<V>(d, p.d_outs + row * H + col);
        load_v<V>(dc, p.d_state0 + (size_t)b * 2 * H + H + col);
        reset = p.resets[row];
    }

    __device__ __forceinline__ void step(const float (&prod)[V], const BwdArgs<float>& p, int t, int b, int col) const {
        const int H = p.H;
        float* state = p.d_state0 + (size_t)b * 2 * H + col;
        float dh[V];
#pragma unroll
        for (int v = 0; v < V; ++v) dh[v] = dh0[v] + prod[v];
        if (t < 0) {
            store_v<V>(state, dh);
            return;
        }
        const bool keep = !(reset > 0.0f);
        float out[4][V], dc_prev[V], zero[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
            const Sig si = sig_bwd<float>(a[0][v]), sf = sig_bwd<float>(add<float>(a[1][v], 1.0f)), so = sig_bwd<float>(a[3][v]);
            const float tg = tanh_t<float>(a[2][v]);
            const float tc = tanh_t<float>(add<float>(mul<float>(sf.s, c[v]), mul<float>(si.s, tg)));
            const float gh = d[v] + (keep ? dh[v] : 0.0f), gc = keep ? dc[v] : 0.0f;
            const float dct = gc + gh * so.s * (1.0f - tc * tc);
            out[0][v] = dct * tg * si.ds, out[1][v] = dct * c[v] * sf.ds, out[2][v] = dct * si.s * (1.0f - tg * tg);
            out[3][v] = gh * tc * so.ds;
            dc_prev[v] = dct * sf.s;
            zero[v] = 0.0f;
        }
        float* da = p.da + ((size_t)t * p.B + b) * 4 * H + col;
#pragma unroll
        for (int g = 0; g < 4; ++g) store_v<V>(da + g * H, out[g]);
        store_v<V>(state, zero);
        store_v<V>(state + H, dc_prev);
    }

    // step t's lines of this row's slice [col, col + U) into L2
    __device__ __forceinline__ static void prefetch(const BwdArgs<float>& p, int t, int b, int col) {
        const int H = p.H;
        const size_t row = (size_t)t * p.B + b;
#pragma unroll
        for (int g = 0; g < 4; ++g) prefetch_l2(p.a + row * 4 * H + g * H + col);
        prefetch_l2(p.cbuf + row * H + col);
        prefetch_l2(p.d_outs + row * H + col);
    }
};

template <int V>
struct GruBwdCells {
    static constexpr int G = 3, SW = 1;
    float x[3][V];   // x_proj[t]
    float hp[3][V];  // h_proj[t] = h_prev @ wh + bh
    float h[V];      // h_prev[t], the carry entering step t
    float d[V];      // d_outs[t]
    float dh0[V];    // the direct term of the carried dh: g * z of step t + 1
    float reset;

    __device__ __forceinline__ void load(const BwdArgs<float>& p, int t, int b, int col) {
        const int H = p.H;
        load_v<V>(dh0, p.d_state0 + (size_t)b * H + col);
        if (t < 0) return;
        const size_t row = (size_t)t * p.B + b;
#pragma unroll
        for (int g = 0; g < 3; ++g) {
            load_v<V>(x[g], p.a + row * 3 * H + g * H + col);
            load_v<V>(hp[g], p.hp + row * 3 * H + g * H + col);
        }
        load_v<V>(h, p.s + row * H + col);
        load_v<V>(d, p.d_outs + row * H + col);
        reset = p.resets[row];
    }

    __device__ __forceinline__ void step(const float (&prod)[V], const BwdArgs<float>& p, int t, int b, int col) const {
        const int H = p.H;
        float* state = p.d_state0 + (size_t)b * H + col;
        float dh[V];
#pragma unroll
        for (int v = 0; v < V; ++v) dh[v] = dh0[v] + prod[v];
        if (t < 0) {
            store_v<V>(state, dh);
            return;
        }
        const bool keep = !(reset > 0.0f);
        float out[3][V], dhn[V], direct[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
            const float hn = hp[2][v];
            const Sig rg = sig_bwd<float>(add<float>(x[0][v], hp[0][v])), zg = sig_bwd<float>(add<float>(x[1][v], hp[1][v]));
            const float n = tanh_t<float>(add<float>(x[2][v], mul<float>(rg.s, hn)));
            const float g = d[v] + (keep ? dh[v] : 0.0f);
            const float dan = g * (1.0f - zg.s) * (1.0f - n * n);
            out[0][v] = dan * hn * rg.ds, out[1][v] = g * (h[v] - n) * zg.ds, out[2][v] = dan;
            dhn[v] = dan * rg.s;
            direct[v] = g * zg.s;
        }
        const size_t row = (size_t)t * p.B + b;
#pragma unroll
        for (int g = 0; g < 3; ++g) store_v<V>(p.da + row * 3 * H + g * H + col, out[g]);
        store_v<V>(p.dhn + row * H + col, dhn);
        store_v<V>(state, direct);
    }

    __device__ __forceinline__ static void prefetch(const BwdArgs<float>& p, int t, int b, int col) {
        const int H = p.H;
        const size_t row = (size_t)t * p.B + b;
#pragma unroll
        for (int g = 0; g < 3; ++g) {
            prefetch_l2(p.a + row * 3 * H + g * H + col);
            prefetch_l2(p.hp + row * 3 * H + g * H + col);
        }
        prefetch_l2(p.s + row * H + col);
        prefetch_l2(p.d_outs + row * H + col);
    }
};

// A persistent cooperative grid of Q batch tiles x S unit slices (blockIdx = tile * S + slice), as grid_kernel, for the
// backward in reverse time. Block (q, r) owns the U hidden units r*U .. r*U+U-1 of its tile's BT rows and holds wh's
// rows of those units (the columns of wh^T that produce their dh) in shared memory for all T steps. Per step t, from
// T-1 down to 0: dh of step t is the product of step t+1's gate cotangents dg[t+1] (all G*H columns of the tile's rows,
// written by every block) with the slice, plus the direct term; the cells of step t write d_x_proj[t] (and d_hn[t]),
// which are dg[t]; one grid barrier; after step 0 the last product gives the first state's cotangent. dg is not
// copied anywhere: LSTM dg[t] = d_x_proj[t]; GRU dg[t] = d_x_proj[t][:, :2H] ++ d_hn[t]. A thread holds 4 x 4
// accumulators: rows p0 + rt + i * RT (i < 4) of the pass from tile row p0, units ct*4 .. ct*4+3. Where K is split
// (KS > 1: one pass, a cell a thread) thread tid owns cell tid, loads its inputs before the product and applies it
// after the splits' sum; otherwise each thread applies the cells of its register tile.
template <template <int> class Cells>
__global__ void __launch_bounds__(kBwdGridThreads, 1)
    seq_bwd_grid_kernel(const BwdArgs<float> p, int U, int BT, int KS, int KC, int passes) {
    constexpr int TM = 4, TN = 4;
    constexpr int G = Cells<1>::G, SW = Cells<1>::SW;
    cg::grid_group grid = cg::this_grid();
    const int H = p.H, B = p.B, GH = G * H, S = H / U, NCT = U / TN, PR = BT / passes, RT = PR / TM, tiles = RT * NCT;
    const int r = static_cast<int>(blockIdx.x) % S, b0 = static_cast<int>(blockIdx.x) / S * BT;
    const int tid = threadIdx.x, threads = blockDim.x;
    const int ct = tid % NCT, rt = tid / NCT % RT, ks = tid / tiles;  // tid = (ks * RT + rt) * NCT + ct
    const int rows = min(BT, B - b0);                                   // live rows of this tile
    const int HS = KC + 4, L = KC / KS, chunks = GH / KC;
    const bool own_cell = KS > 1 && tid < rows * U;
    const int cell_row = tid / U, cell_col = r * U + tid % U;

    extern __shared__ __align__(16) unsigned char smem[];
    float* w_s = reinterpret_cast<float*>(smem);  // [G*H][U]: wh[r*U + u][c] at c * U + u
    float* g_s = w_s + (size_t)GH * U;            // [2][PR][HS]: chunks of a pass's dg rows, K contiguous
    float* red = g_s + 2 * PR * HS;               // [KS][tiles][16]: partial sums of the K splits

    // the slice, once: wh's rows r*U .. r*U+U-1 (G*H contiguous columns each), transposed
    for (int i = tid; i < U * (GH / 4); i += threads) {
        const int u = i / (GH / 4), c = i % (GH / 4) * 4;
        const float4 w = *reinterpret_cast<const float4*>(p.wt + (size_t)(r * U + u) * GH + c);
        w_s[c * U + u] = w.x;
        w_s[(c + 1) * U + u] = w.y;
        w_s[(c + 2) * U + u] = w.z;
        w_s[(c + 3) * U + u] = w.w;
    }
    for (int i = tid; i < 2 * PR * HS; i += threads) g_s[i] = 0.0f;  // rows past B stay zero in the product
    // the cells' carried cotangents start as the final state's
    for (int i = tid; i < rows * U; i += threads) {
        const size_t o = (size_t)(b0 + i / U) * SW * H + r * U + i % U;
#pragma unroll
        for (int part = 0; part < SW; ++part) p.d_state0[o + part * H] = p.d_final[o + part * H];
    }
    if constexpr (G == 4) {
        // the cell state entering each step, recomputed forward in time for this block's cells into cbuf; a thread
        // takes NC cells at a time, so that their loads of a step are in flight together
        constexpr int NC = 8;
        for (int i0 = tid; i0 < rows * U; i0 += NC * threads) {
            float c[NC];
#pragma unroll
            for (int k = 0; k < NC; ++k) {
                const int i = i0 + k * threads;
                c[k] = i < rows * U ? p.s[(size_t)(b0 + i / U) * 2 * H + H + r * U + i % U] : 0.0f;
            }
            for (int t = 0; t < p.steps; ++t) {
                float pi[NC], pf[NC], pg[NC], reset[NC];
#pragma unroll
                for (int k = 0; k < NC; ++k) {
                    const int i = i0 + k * threads;
                    if (i >= rows * U) continue;
                    const size_t row = (size_t)t * B + b0 + i / U;
                    const float* pr = p.a + row * GH + r * U + i % U;
                    pi[k] = pr[0], pf[k] = pr[H], pg[k] = pr[2 * H], reset[k] = p.resets[row];
                }
#pragma unroll
                for (int k = 0; k < NC; ++k) {
                    const int i = i0 + k * threads;
                    if (i >= rows * U) continue;
                    p.cbuf[((size_t)t * B + b0 + i / U) * H + r * U + i % U] = c[k];
                    const float new_c = add<float>(mul<float>(sig_bwd<float>(add<float>(pf[k], 1.0f)).s, c[k]),
                                                   mul<float>(sig_bwd<float>(pi[k]).s, tanh_t<float>(pg[k])));
                    c[k] = reset[k] > 0.0f ? 0.0f : new_c;
                }
            }
        }
    }
    __syncthreads();  // d_state0 and cbuf, written by this block's threads, are read by the cells' owners
    // no grid barrier yet: the cells of step T-1 read nothing that another block writes

    // step t's inputs of this tile's cells into L2
    auto prefetch_step = [&](int t) {
        for (int i = tid; i < rows; i += threads) Cells<1>::prefetch(p, t, b0 + i, r * U);
        for (int i = tid * 32; i < rows; i += threads * 32) prefetch_l2(p.resets + (size_t)t * B + b0 + i);
    };
    prefetch_step(p.steps - 1);

    for (int t = p.steps - 1; t >= -1; --t) {
        PHASE_MARK(c0);
        const bool product = t + 1 < p.steps;  // dg[t + 1] exists: every step but the last one's cells
        if (t > 0) prefetch_step(t - 1);
        Cells<1> mine;
        if (own_cell) mine.load(p, t, b0 + cell_row, cell_col);
        PHASE_MARK(c1);
        // the source of dg[t + 1][b][k .. k + 3]: d_x_proj's row, or the GRU's d_hn past its r and z columns
        auto dg = [&](int b, int k) -> const float* {
            const size_t row = (size_t)(t + 1) * B + b;
            if (G == 3 && k >= 2 * H) return p.dhn + row * H + (k - 2 * H);
            return p.da + row * GH + k;
        };

        for (int pass = 0; pass < passes; ++pass) {
            const int p0 = pass * PR, prows = min(PR, rows - p0);
            if (prows <= 0) break;
            PHASE_MARK(q0);
            float acc[TM][TN];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
            if (product) {
                // chunk c of the pass's dg rows: prows x KC, 16-byte copies through L2 only (cp.async.cg): the other
                // blocks wrote them before the barrier, and an L1 line of an earlier step must not be read
                auto load_chunk = [&](int c) {
                    float* dst = g_s + (c & 1) * PR * HS;
                    const int pieces = KC / 4;
                    for (int i = tid; i < prows * pieces; i += threads) {
                        const int row = i / pieces, k = i % pieces * 4;
#ifndef RNN_SEQ_BWD_ABLATE_LOADS
                        cp_async16(dst + row * HS + k, dg(b0 + p0 + row, c * KC + k));
#endif
                    }
                    cp_async_commit();
                };
                // two stages: chunk c + 1 loads while chunk c is multiplied
                load_chunk(0);
                for (int c = 0; c < chunks; ++c) {
                    if (c + 1 < chunks) {
                        load_chunk(c + 1);
                        cp_async_wait<1>();
                    } else {
                        cp_async_wait<0>();
                    }
                    __syncthreads();
                    // this thread's split of the chunk: K from c * KC + ks * L, L long
                    const float* gs = g_s + (c & 1) * PR * HS + ks * L;
                    const float* ws = w_s + (size_t)(c * KC + ks * L) * U + ct * 4;
#ifdef RNN_SEQ_BWD_ABLATE_PRODUCT
                    if (L < 0)
#endif
                    for (int kk = 0; kk < L; kk += 4) {
                        float4 a[TM], w[4];
#pragma unroll
                        for (int i = 0; i < TM; ++i) a[i] = *reinterpret_cast<const float4*>(gs + (rt + i * RT) * HS + kk);
#pragma unroll
                        for (int e = 0; e < 4; ++e) w[e] = *reinterpret_cast<const float4*>(ws + (kk + e) * U);
#pragma unroll
                        for (int e = 0; e < 4; ++e)
#pragma unroll
                            for (int i = 0; i < TM; ++i) {
                                const float gv = e == 0 ? a[i].x : e == 1 ? a[i].y : e == 2 ? a[i].z : a[i].w;
                                acc[i][0] = fmaf(gv, w[e].x, acc[i][0]);
                                acc[i][1] = fmaf(gv, w[e].y, acc[i][1]);
                                acc[i][2] = fmaf(gv, w[e].z, acc[i][2]);
                                acc[i][3] = fmaf(gv, w[e].w, acc[i][3]);
                            }
                    }
                    __syncthreads();  // the stage is free for chunk c + 2 (or the next pass)
                }
            }
            PHASE_MARK(q1);

            if (KS > 1) {
                // the splits' partial sums through shared memory; each cell adds its own
                float prod[1] = {0.0f};
                if (product) {
                    float* part = red + (size_t)tid * TM * TN;
#pragma unroll
                    for (int i = 0; i < TM; ++i)
                        *reinterpret_cast<float4*>(part + i * TN) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
                    __syncthreads();
                    if (own_cell) {
                        const int u = tid % U;
                        const float* q = red + (size_t)(cell_row % RT * NCT + u / TN) * TM * TN + cell_row / RT * TN + u % TN;
#pragma unroll 4
                        for (int s = 0; s < KS; ++s) prod[0] += q[(size_t)s * tiles * TM * TN];
                    }
                    __syncthreads();  // red is free for the next step
                }
                if (own_cell) mine.step(prod, p, t, b0 + cell_row, cell_col);
            } else {
                // row by row, the next row's inputs loaded before this row's cells are applied
                const int col = r * U + ct * TN;
                Cells<TN> cells[2];
                if (p0 + rt < rows) cells[0].load(p, t, b0 + p0 + rt, col);
#pragma unroll
                for (int i = 0; i < TM; ++i) {
                    const int row = p0 + rt + i * RT;
                    if (i + 1 < TM && row + RT < rows) cells[(i + 1) & 1].load(p, t, b0 + row + RT, col);
                    if (row < rows) cells[i & 1].step(acc[i], p, t, b0 + row, col);
                }
            }
            PHASE_MARK(q2);
            PHASE_ADD(0, q0, q1);  // the dg loads and the product
            PHASE_ADD(1, q1, q2);  // the splits' sums and the cells
        }
        PHASE_MARK(c3);
        if (t >= 0) grid.sync();  // dg[t] is in L2 for every block
        PHASE_MARK(c4);
        PHASE_ADD(2, c0, c1);  // the next step's prefetch and the split path's input loads
        PHASE_ADD(3, c3, c4);  // the grid barrier
    }
}

template <template <int> class Cells>
int launch_bwd_grid(const BwdArgs<float>& p, int U, int BT, int KS, int KC, int passes, int threads, int smem, void* stream) {
    constexpr int G = Cells<1>::G;
    if (p.steps < 1 || p.B < 1 || p.H < 4 || U < 4 || U % 4 != 0 || p.H % U != 0 || passes < 1 || BT % (passes * 4) != 0 ||
        KS < 1 || KC < 4 || p.H % KC != 0 || KC % (4 * KS) != 0 || threads != bwd_grid_threads(U, BT, KS, passes) ||
        threads < 1 || threads > kBwdGridThreads || (KS > 1 && (passes > 1 || BT * U > threads)) ||
        (size_t)smem != bwd_grid_smem_bytes(G, p.H, U, BT, KS, KC, passes))
        return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = seq_bwd_grid_kernel<Cells>;
    const int grid = (p.B + BT - 1) / BT * (p.H / U);

    // The shared-memory limit and the check that the whole grid is resident at once, once per configuration,
    // device and process, as launch_grid has them; a cooperative launch that does not fit is refused.
    static std::mutex lock;
    static std::map<int, int> smem_set;                            // device -> the limit set there
    static std::set<std::pair<int, std::pair<int, int>>> checked;  // (device, (threads, smem))
    cudaError_t err = cudaSuccess;
    {
        std::lock_guard<std::mutex> guard(lock);
        int dev = 0;
        err = cudaGetDevice(&dev);
        if (err != cudaSuccess) return failed(err);
        if (smem > smem_set[dev]) {
            err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (err != cudaSuccess) return failed(err);
            smem_set[dev] = smem;
        }
        if (!checked.count({dev, {threads, smem}})) {
            int per_sm = 0, sms = 0;
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
            if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
            if (err != cudaSuccess) return failed(err);
            if (per_sm * sms < grid) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
            checked.insert({dev, {threads, smem}});
        }
    }
    BwdArgs<float> args_p = p;
    void* args[] = {&args_p, &U, &BT, &KS, &KC, &passes};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid), dim3(threads), args, smem,
                                      static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return failed(err);
    return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ backward (BPTT): the cluster design

// K of a cluster backward block's product: its G*U gate columns, rounded up to the mma's k16 in bf16 (the extra rows of the
// wh slice and columns of dg are zero).
__host__ __device__ constexpr int bwd_cluster_k(int GU, int elem) { return elem == 2 ? (GU + 15) / 16 * 16 : GU; }

// Dynamic shared memory of one cluster backward block; ops/cuda_rnn.py:bwd_cluster_smem is the same formula. Each part
// starts on 16 bytes: the block's rows of pack_wh [K][H + pad] in T; the gate cotangents of its units, dg [BT][K] (bf16: a
// high and a low part, rows of K + 8; f32: rows of K); the receive slots of the partial products [buffers][C][BT][U] f32; the
// stage of a step's inputs (x_proj or proj, and the GRU's h_proj, [BT][G*U] in T; h_prev or c, and d_outs, [BT][U] f32;
// resets [BT] f32); the carried cotangents [BT][U] f32 (the direct term of dh, and the LSTM's dc).
inline size_t bwd_cluster_smem_bytes(int G, int H, int C, int BT, int elem, int buffers) {
    const size_t U = H / C, GU = G * U, K = bwd_cluster_k(static_cast<int>(GU), elem), HS = H + 16 / elem, R = BT;
    const size_t dg = elem == 2 ? 2 * align16(2 * R * (K + 8)) : align16(4 * R * K);
    return align16(elem * K * HS) + dg + align16(4 * static_cast<size_t>(buffers) * R * H) + (G == 3 ? 2 : 1) * align16(elem * R * GU) +
           2 * align16(4 * R * U) + align16(4 * R) + (G == 4 ? 2 : 1) * align16(4 * R * U);
}

// The cycles of thread 0 in a span, added to `var`, in the phase-clock build only.
#ifdef RNN_SEQ_PHASES
#define PHASE_SPAN(var, from, to) var += (to) - (from)
#else
#define PHASE_SPAN(var, from, to)
#endif

// ldmatrix.trans: four 8x8 bf16 matrices transposed; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// 16-byte copies of a block's units of step rows: dst[row][g * U + e] <- src[(row0 + row) * G * H + g * H + r * U + e] for
// rows < live (U = 1 << lu, at least 16 bytes of E). G is a constant, so that the index math is shifts and a multiply.
template <typename E, int G>
__device__ __forceinline__ void stage_units(E* dst, const E* src, size_t row0, int live, int H, int r, int lu) {
    constexpr int PER = 16 / sizeof(E);
    const int lpg = lu - (sizeof(E) == 2 ? 3 : 2), U = 1 << lu;  // lpg: log2 of the copies of a run of U
    for (int i = threadIdx.x; i < (live * G) << lpg; i += kThreads) {
        const int rg = i >> lpg, c = i & ((1 << lpg) - 1), row = rg / G, g = rg - row * G;
        cp_async16(dst + rg * U + c * PER, src + (row0 + row) * G * H + g * H + r * U + c * PER);
    }
}

// The partial product P[BT][H] = dg[BT][K] @ w[K][H] of one block on the tensor cores, dg in two bf16 parts (high and low,
// two mmas into one f32 sum: wh is exact in bf16, so the product keeps dg's f32 to about 2^-16). A warp item is one m16 row
// tile x NJ n8 column tiles: A from dg by ldmatrix, B from the [K][H] slice by ldmatrix.trans. The sums go from the
// accumulators straight into the slot `slot` (this block's, at the same offset in every block) of the block that owns each
// column (column n: block n / U, unit n % U): lanes q and q ^ 1 trade halves so that each stores 4 neighbouring columns of
// one row, a 16-byte store through distributed shared memory. `push`: thread 0's cycles in those stores (phase build).
template <int NJ>
__device__ __forceinline__ void bwd_mma_push(cg::cluster_group& cluster, const __nv_bfloat16* dgh, const __nv_bfloat16* dgl,
                                             const __nv_bfloat16* w, float* slot, int BT, int H, int K, int DS, int HS, int U,
                                             int lu, long long& push) {
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    const bool odd = q & 1;
    const int groups = H / (8 * NJ);
    for (int item = threadIdx.x >> 5; item < BT / 16 * groups; item += kThreads / 32) {
        const int m0 = item / groups * 16, n0 = item % groups * 8 * NJ;
        const int a_at = (m0 + (lane & 7) + (lane >> 3 & 1) * 8) * DS + (lane >> 4) * 8;
        const __nv_bfloat16* pb = w + ((lane & 7) + (lane >> 3 & 1) * 8) * HS + n0 + (lane >> 4) * 8;
        float d[NJ][4] = {}, e[NJ][4] = {};  // the high and the low part's sums: two independent chains of mmas
        for (int k = 0; k < K; k += 16) {
            uint32_t ah[4], al[4], b[NJ][2];
            ldsm(ah, dgh + a_at + k);
            ldsm(al, dgl + a_at + k);
#pragma unroll
            for (int j = 0; j < NJ; j += 2) {  // two n8 tiles per x4: rows k .. k + 15 of columns n0 + 8j .. n0 + 8j + 15
                uint32_t r[4];
                ldsm_t(r, pb + k * HS + j * 8);
                b[j][0] = r[0], b[j][1] = r[1], b[j + 1][0] = r[2], b[j + 1][1] = r[3];
            }
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                mma_bf16(d[j], ah, b[j][0], b[j][1]);
                mma_bf16(e[j], al, b[j][0], b[j][1]);
            }
        }
        PHASE_MARK(s0);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int v = 0; v < 4; ++v) d[j][v] += e[j][v];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            // lane (g, q) holds rows m0 + g and m0 + g + 8 of columns 2q, 2q + 1: the even lane keeps row g, the odd row g + 8
            const float x0 = odd ? d[j][0] : d[j][2], x1 = odd ? d[j][1] : d[j][3];
            const float y0 = __shfl_xor_sync(0xffffffffu, x0, 1), y1 = __shfl_xor_sync(0xffffffffu, x1, 1);
            const float4 v = odd ? make_float4(y0, y1, d[j][2], d[j][3]) : make_float4(d[j][0], d[j][1], y0, y1);
            const int row = m0 + g + (odd ? 8 : 0), col = n0 + j * 8 + 2 * (q & 2);
            float* dst = slot + row * U + (col & (U - 1));
            *reinterpret_cast<float4*>(cluster.map_shared_rank(dst, col >> lu)) = v;
        }
        PHASE_MARK(s1);
        PHASE_SPAN(push, s0, s1);
    }
}

// The same partial product in f32 FMAs on the CUDA cores (TF32 would break the f32 tolerance): a thread takes RB rows and 4
// neighbouring columns, reads a float4 of the [K][H] slice per k and dg as broadcast float4s, and stores its RB float4 sums
// into the owning block's slot. RB = 8 reads the slice half as often as RB = 4; it is taken where 8 warps stay busy (with 4,
// one a scheduler, nothing hides the loads' latency).
template <int RB>
__device__ __forceinline__ void bwd_fma_push(cg::cluster_group& cluster, const float* dg, const float* w, float* slot, int BT, int H,
                                             int K, int HS, int U, int lu, long long& push) {
    const int cols = H / 4;
    for (int it = threadIdx.x; it < cols * (BT / RB); it += kThreads) {
        const int c = it % cols * 4, r0 = it / cols * RB;
        float s[RB][4] = {};
        const float* gk = dg + r0 * K;
        for (int k = 0; k < K; k += 4) {
            float4 wv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) wv[e] = *reinterpret_cast<const float4*>(w + (k + e) * HS + c);
#pragma unroll
            for (int i = 0; i < RB; ++i) {
                const float4 a = *reinterpret_cast<const float4*>(gk + i * K + k);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const float av = e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
                    s[i][0] = fmaf(av, wv[e].x, s[i][0]);
                    s[i][1] = fmaf(av, wv[e].y, s[i][1]);
                    s[i][2] = fmaf(av, wv[e].z, s[i][2]);
                    s[i][3] = fmaf(av, wv[e].w, s[i][3]);
                }
            }
        }
        PHASE_MARK(s0);
#pragma unroll
        for (int i = 0; i < RB; ++i) {
            float* dst = slot + (r0 + i) * U + (c & (U - 1));
            *reinterpret_cast<float4*>(cluster.map_shared_rank(dst, c >> lu)) = make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
        }
        PHASE_MARK(s1);
        PHASE_SPAN(push, s0, s1);
    }
}

// The forward's cluster design mirrored, in reverse time (G = 3: the GRU, 4: the LSTM). A cluster of C blocks owns BT batch
// rows; block r owns the U = H / C units r*U .. r*U+U-1 and keeps pack_wh's rows of them (the forward's slice: its G*U gate
// columns of wh, each a row of H) in shared memory for all T steps. Per step t, T-1 down to 0:
//   - the cells of its units take their new state's cotangent g = d_outs[t] + dh (dh: the C receive slots of step t+1 summed
//     in block order 0..C-1, plus the direct term; the final state's cotangent at t = T-1; 0 after a reset), recompute their
//     gates from the staged pre-activations in T as seq_bwd_kernel does (each op rounded to T, the -88 clamp), write
//     d_x_proj[t] (and the GRU's d_hn[t]), and keep their gate cotangents dg [BT][G*U] in f32 (bf16: a high and a low part);
//   - the copies of step t-1's inputs start;
//   - the partial product P = dg @ slice [BT][H] (K = G*U): each block's columns go into its receive slot r;
//   - one cluster barrier (release / acquire). The slots are double buffered (buffers = 2: a slot is rewritten only after
//     every block has passed the barrier that ends the step which read it); with one buffer a second barrier, before the
//     product, keeps a slot until every block has read it.
// After step 0 the slots give the first state's cotangent. The LSTM first recomputes the cell state entering each step,
// forward in time, for its units into cbuf (the forward saves h, not c). Rows past B stay zero in dg, so every sum is finite.
template <typename T, int G>
__global__ void __launch_bounds__(kThreads, 1) seq_bwd_cluster_kernel(const BwdArgs<T> p, int BT, int buffers) {
    constexpr bool kLstm = G == 4, kBf16 = sizeof(T) == 2;
    constexpr int SW = kLstm ? 2 : 1;
    cg::cluster_group cluster = cg::this_cluster();
    const int C = static_cast<int>(cluster.dim_blocks().x), r = static_cast<int>(cluster.block_rank());
    const int H = p.H, B = p.B, GH = G * H, U = H / C, lu = __ffs(U) - 1, GU = G * U;
    const int K = bwd_cluster_k(GU, sizeof(T)), HS = H + row_pad<T>(), DS = kBf16 ? K + 8 : K;
    const int b0 = static_cast<int>(blockIdx.x) / C * BT, live = min(BT, B - b0);
    const int tid = threadIdx.x;

    extern __shared__ __align__(16) unsigned char smem[];
    unsigned char* cur = smem;
    auto take = [&](size_t bytes) {
        unsigned char* at = cur;
        cur += align16(bytes);
        return at;
    };
    T* w_s = reinterpret_cast<T*>(take(sizeof(T) * (size_t)K * HS));  // [K][HS]: pack_wh's block r, then zero rows
    __nv_bfloat16* dgh = kBf16 ? reinterpret_cast<__nv_bfloat16*>(take(2 * (size_t)BT * DS)) : nullptr;  // [BT][DS]
    __nv_bfloat16* dgl = kBf16 ? reinterpret_cast<__nv_bfloat16*>(take(2 * (size_t)BT * DS)) : nullptr;
    float* dgf = kBf16 ? nullptr : reinterpret_cast<float*>(take(4 * (size_t)BT * DS));  // [BT][K]
    float* recv = reinterpret_cast<float*>(take(4 * (size_t)buffers * BT * H));  // [buffers][C][BT][U]
    T* sa = reinterpret_cast<T*>(take(sizeof(T) * (size_t)BT * GU));                   // x_proj or proj [BT][G*U]
    T* shp = kLstm ? nullptr : reinterpret_cast<T*>(take(sizeof(T) * (size_t)BT * GU));  // the GRU's h_proj
    float* sv = reinterpret_cast<float*>(take(4 * (size_t)BT * U));  // h_prev (GRU) or c (LSTM) of the step
    float* sd = reinterpret_cast<float*>(take(4 * (size_t)BT * U));  // d_outs of the step
    float* sr = reinterpret_cast<float*>(take(4 * (size_t)BT));      // resets of the step
    float* dhd = reinterpret_cast<float*>(take(4 * (size_t)BT * U));  // the direct term of dh: the GRU's g * z, else 0
    float* dcs = kLstm ? reinterpret_cast<float*>(take(4 * (size_t)BT * U)) : nullptr;  // the LSTM's carried dc

    // the slice, once: pack_wh's rows r*G*U .. r*G*U+G*U-1 (H contiguous each); rows G*U .. K-1 zero
    const T* w_src = p.wt + (size_t)r * GU * H;
    const int w_chunks = H * static_cast<int>(sizeof(T)) / 16;
    for (int i = tid; i < GU * w_chunks; i += kThreads) {
        const int n = i / w_chunks, c = i % w_chunks;
        cp_async16(reinterpret_cast<uint4*>(w_s + n * HS) + c, reinterpret_cast<const uint4*>(w_src + (size_t)n * H) + c);
    }
    for (int i = tid; i < (K - GU) * HS; i += kThreads) w_s[GU * HS + i] = Num<T>::to(0.0f);
    for (int i = tid; i < BT * DS; i += kThreads) {
        if constexpr (kBf16) {
            dgh[i] = __float2bfloat16_rn(0.0f), dgl[i] = __float2bfloat16_rn(0.0f);
        } else {
            dgf[i] = 0.0f;
        }
    }
    // the carried cotangents start as the final state's
    for (int i = tid; i < live * U; i += kThreads) {
        const size_t o = (size_t)(b0 + (i >> lu)) * SW * H + r * U + (i & (U - 1));
        dhd[i] = p.d_final[o];
        if constexpr (kLstm) dcs[i] = p.d_final[o + H];
    }
    if constexpr (kLstm) {
        // the cell state entering each step, as the forward computed it, into cbuf; a cell's inputs of TS steps are loaded
        // before they are used, so that they are in flight together
        constexpr int TS = 8;
        for (int i = tid; i < live * U; i += kThreads) {
            const int b = b0 + (i >> lu), j = r * U + (i & (U - 1));
            float c = Num<T>::round(p.s[(size_t)b * 2 * H + H + j]);
            for (int t0 = 0; t0 < p.steps; t0 += TS) {
                float pi[TS], pf[TS], pg[TS], reset[TS];
#pragma unroll
                for (int k = 0; k < TS; ++k) {
                    if (t0 + k >= p.steps) break;
                    const size_t row = (size_t)(t0 + k) * B + b;
                    const T* pr = p.a + row * GH + j;
                    pi[k] = Num<T>::load(pr), pf[k] = Num<T>::load(pr + H), pg[k] = Num<T>::load(pr + 2 * H), reset[k] = p.resets[row];
                }
#pragma unroll
                for (int k = 0; k < TS; ++k) {
                    if (t0 + k >= p.steps) break;
                    p.cbuf[((size_t)(t0 + k) * B + b) * H + j] = c;
                    const float new_c = add<T>(mul<T>(sig_bwd<T>(add<T>(pf[k], 1.0f)).s, c), mul<T>(sig_bwd<T>(pi[k]).s, tanh_t<T>(pg[k])));
                    c = reset[k] > 0.0f ? 0.0f : new_c;
                }
            }
        }
        __syncthreads();  // cbuf, written by this block's threads, is read by the stage copies below
    }

    auto stage = [&](int t) {
        const size_t row0 = (size_t)t * B + b0;
        stage_units<T, G>(sa, p.a, row0, live, H, r, lu);
        if constexpr (!kLstm) stage_units<T, 3>(shp, p.hp, row0, live, H, r, lu);
        stage_units<float, 1>(sv, kLstm ? p.cbuf : p.s, row0, live, H, r, lu);
        stage_units<float, 1>(sd, p.d_outs, row0, live, H, r, lu);
        for (int i = tid; i < live; i += kThreads) cp_async4(sr + i, p.resets + row0 + i);
        cp_async_commit();
    };
    stage(p.steps - 1);
    cluster.sync();  // every block of the cluster has started: its slots may be written

    const bool wide = !kBf16 && (H / 4) * (BT / 8) >= 256;  // f32: 8 rows a thread where that keeps 8 warps busy, else 4
    const bool nj4 = kBf16 && (BT / 16) * (H / 32) % 16 == 0;  // bf16: 4 n8 tiles a warp item where the items share the warps evenly
    long long push = 0;
    (void)push;
    for (int t = p.steps - 1; t >= 0; --t) {
        PHASE_MARK(c0);
        const int rb = buffers == 2 ? (t + 1) & 1 : 0, wb = buffers == 2 ? t & 1 : 0;  // the slots read and written at step t
        cp_async_wait<0>();
        __syncthreads();  // step t's inputs (and, before step T-1, the slice) have landed
        for (int i = tid; i < live * U; i += kThreads) {
            const int row = i >> lu, u = i & (U - 1);
            float dh = dhd[i];
            if (t + 1 < p.steps) {
                float sum = 0.0f;
                const float* in = recv + (size_t)rb * C * BT * U + row * U + u;
                for (int s = 0; s < C; ++s) sum += in[(size_t)s * BT * U];
                dh = sum + dh;
            }
            const size_t o = ((size_t)t * B + b0 + row) * GH + r * U + u;
            const T* a = sa + row * GU + u;
            const bool keep = !(sr[row] > 0.0f);
            float out[G];
            if constexpr (kLstm) {
                const float pi = Num<T>::load(a), pf = Num<T>::load(a + U), pg = Num<T>::load(a + 2 * U), po = Num<T>::load(a + 3 * U);
                const float fa = add<T>(pf, 1.0f);
                const Sig si = sig_bwd<T>(pi), sf = sig_bwd<T>(fa), so = sig_bwd<T>(po);
                const float tg = tanh_t<T>(pg), c = sv[i];
                const float tc = tanh_t<T>(add<T>(mul<T>(sf.s, c), mul<T>(si.s, tg)));
                const float gh = sd[i] + (keep ? dh : 0.0f), gc = keep ? dcs[i] : 0.0f;
                const float dct = gc + gh * so.s * (1.0f - tc * tc);
                out[0] = dct * tg * si.ds, out[1] = dct * c * sf.ds, out[2] = dct * si.s * (1.0f - tg * tg), out[3] = gh * tc * so.ds;
                dcs[i] = dct * sf.s;
                dhd[i] = 0.0f;
#pragma unroll
                for (int g = 0; g < 4; ++g) p.da[o + g * H] = Num<T>::to(out[g]);
            } else {
                const T* hp = shp + row * GU + u;
                const float hn = Num<T>::load(hp + 2 * U);
                const Sig rg = sig_bwd<T>(add<T>(Num<T>::load(a), Num<T>::load(hp)));
                const Sig zg = sig_bwd<T>(add<T>(Num<T>::load(a + U), Num<T>::load(hp + U)));
                const float n = tanh_t<T>(add<T>(Num<T>::load(a + 2 * U), mul<T>(rg.s, hn)));
                const float h = Num<T>::round(sv[i]);
                const float g = sd[i] + (keep ? dh : 0.0f);
                const float dan = g * (1.0f - zg.s) * (1.0f - n * n);
                const float dar = dan * hn * rg.ds, daz = g * (h - n) * zg.ds, dhn = dan * rg.s;
                dhd[i] = g * zg.s;  // the direct term of dh_prev; the slots add d_h_proj @ wh^T
                p.da[o] = Num<T>::to(dar), p.da[o + H] = Num<T>::to(daz), p.da[o + 2 * H] = Num<T>::to(dan);
                p.dhn[((size_t)t * B + b0 + row) * H + r * U + u] = Num<T>::to(dhn);
                out[0] = dar, out[1] = daz, out[2] = dhn;  // d_h_proj: the product's gate cotangents
            }
#pragma unroll
            for (int g = 0; g < G; ++g) {
                const int at = row * DS + g * U + u;
                if constexpr (kBf16) {
                    const __nv_bfloat16 hi = __float2bfloat16_rn(out[g]);
                    dgh[at] = hi, dgl[at] = __float2bfloat16_rn(out[g] - __bfloat162float(hi));
                } else {
                    dgf[at] = out[g];
                }
            }
        }
        __syncthreads();  // dg is whole; the stage is free
        PHASE_MARK(c1);
        if (t > 0) stage(t - 1);
        if (buffers == 1) cluster.sync();  // every block has read its slots before any is rewritten
        PHASE_MARK(c2);
        float* slot = recv + ((size_t)wb * C + r) * BT * U;
        if constexpr (kBf16) {
            if (nj4) bwd_mma_push<4>(cluster, dgh, dgl, reinterpret_cast<const __nv_bfloat16*>(w_s), slot, BT, H, K, DS, HS, U, lu, push);
            else bwd_mma_push<2>(cluster, dgh, dgl, reinterpret_cast<const __nv_bfloat16*>(w_s), slot, BT, H, K, DS, HS, U, lu, push);
        } else {
            if (wide) bwd_fma_push<8>(cluster, dgf, reinterpret_cast<const float*>(w_s), slot, BT, H, K, HS, U, lu, push);
            else bwd_fma_push<4>(cluster, dgf, reinterpret_cast<const float*>(w_s), slot, BT, H, K, HS, U, lu, push);
        }
        PHASE_MARK(c3);
        cluster.sync();  // barrier.cluster arrive.release / wait.acquire: every block's slot r is written
        PHASE_MARK(c4);
        PHASE_ADD(0, c2, c3);  // the product with its pushes (their cycles also counted apart, below)
        PHASE_ADD(1, c0, c1);  // the wait for the step's inputs and the cells
        PHASE_ADD(3, c3, c4);  // the barrier (and, with one buffer, the one before the product: phase 2 holds it)
        PHASE_ADD(2, c1, c2);  // the next step's copies issued (and the second barrier with one buffer)
    }
#ifdef RNN_SEQ_PHASES
    if (threadIdx.x == 0) atomicAdd(&rnn_seq_phase_cycles[4], static_cast<unsigned long long>(push));
#endif
    // the last barrier above is every block's last access to a peer's shared memory
    for (int i = tid; i < live * U; i += kThreads) {
        const int row = i >> lu, u = i & (U - 1);
        float sum = 0.0f;
        for (int s = 0; s < C; ++s) sum += recv[(size_t)s * BT * U + row * U + u];  // step 0 wrote buffer 0
        const size_t o = (size_t)(b0 + row) * SW * H + r * U + u;
        p.d_state0[o] = sum + dhd[i];
        if constexpr (kLstm) p.d_state0[o + H] = dcs[i];
    }
}

template <typename T, int G>
int launch_bwd_cluster(const BwdArgs<T>& p, int C, int BT, int buffers, int smem, cudaStream_t stream) {
    const int m = sizeof(T) == 2 ? 16 : 8;  // row granularity: the mma's m16, or 8 rows (the f32 product's row groups)
    const int U = C >= 1 ? p.H / C : 0;
    if (p.steps < 1 || p.B < 1 || C < 1 || C > 16 || p.H % C != 0 || p.H % 64 != 0 || U < 8 || (U & (U - 1)) != 0 || BT < m ||
        BT % m != 0 || buffers < 1 || buffers > 2 || (size_t)smem != bwd_cluster_smem_bytes(G, p.H, C, BT, sizeof(T), buffers))
        return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = seq_bwd_cluster_kernel<T, G>;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(((p.B + BT - 1) / BT) * C);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;

    // the function attributes and the check that a cluster fits on the card, once per configuration, device and process,
    // as launch_cluster has them
    static std::mutex lock;
    static std::map<int, int> smem_set;                            // device -> the limit set there
    static std::set<std::pair<int, std::pair<int, int>>> checked;  // (device, (C, smem))
    cudaError_t err = cudaSuccess;
    {
        std::lock_guard<std::mutex> guard(lock);
        int dev = 0;
        err = cudaGetDevice(&dev);
        if (err != cudaSuccess) return failed(err);
        if (smem > smem_set[dev]) {
            err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
            if (err != cudaSuccess) return failed(err);
            smem_set[dev] = smem;
        }
        if (!checked.count({dev, {C, smem}})) {
            int clusters = 0;
            err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
            if (err != cudaSuccess) return failed(err);
            if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);  // refused: no cluster of C fits
            checked.insert({dev, {C, smem}});
        }
    }
    err = cudaLaunchKernelEx(&cfg, kernel, p, BT, buffers);
    if (err != cudaSuccess) return failed(err);
    return static_cast<int>(cudaGetLastError());
}

template <int G>
int cluster_backward_typed(const void* d_outs, const void* d_final, const void* resets, const void* a, const void* hp, const void* s,
                           const void* wpk, void* cbuf, void* da, void* dhn, void* d_state0, int steps, int B, int H, int is_bf16,
                           int cluster, int rows, int buffers, int smem, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    auto args = [&](auto* typed) {
        using T = std::remove_const_t<std::remove_pointer_t<decltype(typed)>>;
        return BwdArgs<T>{static_cast<const float*>(d_outs), static_cast<const float*>(d_final), static_cast<const float*>(resets),
                          static_cast<const T*>(a), static_cast<const T*>(hp), static_cast<const float*>(s),
                          static_cast<const T*>(wpk), static_cast<float*>(cbuf), static_cast<T*>(da), static_cast<T*>(dhn),
                          static_cast<float*>(d_state0), steps, B, H};
    };
    if (is_bf16) return launch_bwd_cluster<__nv_bfloat16, G>(args(static_cast<__nv_bfloat16*>(nullptr)), cluster, rows, buffers, smem, st);
    return launch_bwd_cluster<float, G>(args(static_cast<float*>(nullptr)), cluster, rows, buffers, smem, st);
}

// ------------------------------------------------------------------ design "resident" (the LSTM where all of wh fits a block)

constexpr int kResidentThreads = 512;     // most threads of a resident block (its row groups x H)
constexpr int kResidentMinThreads = 128;  // the 4 warps a block gets where its rows allow
constexpr int kResidentAhead = 4;         // steps of the backward's cell-state pass whose loads are issued together

// Rows of wh (k) a forward product loads one chunk ahead, by rows a thread: enough FMAs between a load and its use to cover
// the shared-memory latency, within the registers of RT rows (a chunk of wh is KB float4s, of h KB x RT floats, both double
// buffered). H must be a multiple of the largest, 8.
template <int RT>
__host__ __device__ constexpr int resident_kb() { return RT >= 4 ? 2 : RT == 2 ? 4 : 8; }

// Rows a thread of a resident block of R rows at width H owns: 4 or 2 (dividing R) where that still leaves the block
// kResidentMinThreads threads, else 1. ops/cuda_rnn.py:resident_rows_a_thread is the same rule.
__host__ __device__ constexpr int resident_rows_a_thread(int R, int H) {
    return R % 4 == 0 && R / 4 * H >= kResidentMinThreads ? 4 : R % 2 == 0 && R / 2 * H >= kResidentMinThreads ? 2 : 1;
}

// Dynamic shared memory of one resident forward block; ops/cuda_rnn.py:resident_smem is the same formula: wh packed as
// [H][H][4] f32 (row k, unit j, gate g) and the carry h [2][R][H] f32, each on 16 bytes.
inline size_t resident_smem_bytes(int H, int R) {
    return align16(4 * 4 * static_cast<size_t>(H) * H) + align16(4 * 2 * static_cast<size_t>(R) * H);
}

// Dynamic shared memory of one resident backward block; ops/cuda_rnn.py:resident_bwd_smem is the same formula: wh
// [H][4H + 4] f32 (each row padded by 16 bytes) and the gate cotangents dg [2][R][4H] f32, each on 16 bytes.
inline size_t resident_bwd_smem_bytes(int H, int R) {
    const size_t GH = 4 * static_cast<size_t>(H);
    return align16(4 * H * (GH + 4)) + 2 * align16(4 * R * GH);
}

// Design "resident": lstm_resident_forward <- _lstm_kernel (sample_factory_tpu/ops/pallas_gru.py:226-253, pallas_call at :271),
// and lstm_seq_resident_backward <- _lstm_bwd (:311-315), counted as lstm_seq_resident and lstm_seq_resident_bwd. Planned for
// the LSTM at H <= 64 (DMLab's instruction encoder): over a learner minibatch, (16, 1024, 64) f32, in place of the row design,
// which re-read all of wh from L2 every step in every block (64 KB at H=64, 268 MB a launch at that shape), and in a rollout
// slot and the last-value pass in place of a cluster plan of one wave. At H=64 all of wh, 64 KB in f32, fits one block's shared memory; batch rows are
// independent, so a block that owns R rows and all H units needs no other block: no cluster, no grid barrier.
//   - the block copies wh into shared memory once (cp.async, 16 bytes a copy) and keeps it for all T steps: the L2 reads
//     of wh fall to one copy a block (8.4 MB a launch at (16, 1024, 64), R = 8);
//   - a thread owns one unit j and RT consecutive rows (resident_rows_a_thread), so each (row, unit) cell's four gate sums
//     are in one thread and the cell update needs no exchange; a block of R rows has R / RT row groups of H threads, at
//     least 4 warps where R allows;
//   - forward: wh packed by the wrapper as [H][H][4] (pack_wh), so a thread's four gate weights of row k are one 16-byte
//     read, 32 neighbouring units a warp: no bank conflict; h read as a float4 broadcast (a warp's units share their
//     rows). f32 FMAs on the CUDA cores, each gate's sum over k in order (TF32 would break the f32 tolerance), rounded as
//     the plain version rounds it (Num<T>); the carry h double buffered in shared memory, the cell state in the owning
//     thread's registers; one block barrier a step;
//   - backward: wh kept as [H][4H + 4] (each row padded by 16 bytes, so that thread k's float4 reads along row k fall in
//     distinct banks for 8 neighbouring k); dh_prev[r][k] = dg[r][:] @ wh[k][:] reads dg as a float4 broadcast, in four
//     partial sums a row (columns 4q + e, e < 4) added at the end, so that no chain of 4H dependent FMAs sets a step; the
//     carried cotangents dh and dc in the owning thread's registers (the thread of unit j computes both the cell and dh's
//     column j); dg double buffered; one block barrier a step. The cell state entering each step is recomputed first,
//     forward in time, into cbuf, with kResidentAhead steps' loads issued before their math (the row design's pass
//     chained one dependent load a step); the -88 clamp (sig_bwd) and the reset rule as the row design's; d_x_proj and
//     d_hc0 written as seq_bwd_kernel writes them;
//   - the products are software pipelined: the next chunk of k's reads of wh and h (the backward's: the next 4 columns of
//     wh and dg) are issued before the current chunk's FMAs (resident_kb: 8, 4 or 2 rows of wh by the thread's rows, as its
//     registers allow), so that the shared-memory latency does not set each k;
//   - a step's inputs (x_proj and the reset; the backward's proj, c, d_outs and reset) are each thread's own cells', loaded
//     from global memory into registers ahead, while the step before runs its product and cells (the backward's: its
//     product): copying them through shared memory (cp.async, stage_copy) cost 430-760 cycles a step to issue
//     (rnn_seq_phases), and the cells' reads back from it;
//   - a thread's cells are computed for all its rows without a branch (rows past B on zero inputs, their stores
//     predicated), so that the RT cells' chains of exp, division and tanh overlap.
// What bounds it: the chain of T steps, each a product (shared-memory reads: a wavefront a k for each of a warp's four gate
// columns, R/RT row groups each reading all of wh, against 2*R*H*4H FMAs a step) and the cells' transcendental chains; not
// HBM. bf16 x_proj takes wh in f32 (the wrapper converts it once a call; exact).
template <typename T, int RT>
__global__ void __launch_bounds__(kResidentThreads) lstm_resident_kernel(const T* __restrict__ x, const float* __restrict__ hc0,
                                                                         const float* __restrict__ resets, const float* __restrict__ wpk,
                                                                         float* __restrict__ outs, float* __restrict__ hc_final,
                                                                         int steps, int B, int H, int R) {
    const int GH = 4 * H, tid = threadIdx.x, nt = blockDim.x;
    const int j = tid % H, r0 = tid / H * RT;  // this thread's unit and its first row
    const int b0 = static_cast<int>(blockIdx.x) * R, live = min(R, B - b0);

    extern __shared__ __align__(16) unsigned char resident_smem[];
    float* ws = reinterpret_cast<float*>(resident_smem);  // [H][H][4]: row k, unit j, gate g
    float* hs = reinterpret_cast<float*>(resident_smem + align16(4 * (size_t)GH * H));  // [2][R][H]

    stage_copy(ws, wpk, 4 * GH * H);
    cp_async_commit();
    // a step's inputs of this thread's cells, zero past B
    auto load = [&](int t, float (&xv)[RT][4], float (&rv)[RT]) {
#pragma unroll
        for (int i = 0; i < RT; ++i) {
            const bool in = t < steps && r0 + i < live;
            const size_t row = (size_t)t * B + b0 + r0 + i;
#pragma unroll
            for (int g = 0; g < 4; ++g) xv[i][g] = in ? Num<T>::load(x + row * GH + g * H + j) : 0.0f;
            rv[i] = in ? resets[row] : 0.0f;
        }
    };
    float xv[RT][4], rv[RT];
    load(0, xv, rv);
    // the carry is only ever used as a T operand, so it is kept rounded to T; rows past B stay zero
    for (int i = tid; i < 2 * R * H; i += nt) {
        const int r = i / H % R, k = i % H;
        hs[i] = i < R * H && r < live ? Num<T>::round(hc0[(size_t)(b0 + r) * 2 * H + k]) : 0.0f;
    }
    float c[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) c[i] = r0 + i < live ? Num<T>::round(hc0[(size_t)(b0 + r0 + i) * 2 * H + H + j]) : 0.0f;
    cp_async_wait<0>();
    __syncthreads();

    for (int t = 0; t < steps; ++t) {
        const int s = t & 1;
        PHASE_MARK(c0);
        float xn[RT][4], rn[RT];
        load(t + 1, xn, rn);  // in flight while this step runs
        PHASE_MARK(c1);
        // the product, k in order for each gate's sum; chunk k0 + KB's reads issued before chunk k0's FMAs
        constexpr int KB = resident_kb<RT>();
        float acc[RT][4];
#pragma unroll
        for (int i = 0; i < RT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
        const float* hr = hs + (size_t)s * R * H + r0 * H;
        const float* w = ws + 4 * j;
        float4 wc[KB];
        float hc[RT][KB];
        auto chunk = [&](int k0, float4 (&wd)[KB], float (&hd)[RT][KB]) {
#pragma unroll
            for (int e = 0; e < KB; ++e) {
                wd[e] = *reinterpret_cast<const float4*>(w + (size_t)(k0 + e) * GH);
#pragma unroll
                for (int i = 0; i < RT; ++i) hd[i][e] = hr[i * H + k0 + e];  // a broadcast
            }
        };
        chunk(0, wc, hc);
        for (int k0 = 0; k0 < H; k0 += KB) {
            float4 wnext[KB];
            float hnext[RT][KB];
            chunk(k0 + KB < H ? k0 + KB : k0, wnext, hnext);
#pragma unroll
            for (int e = 0; e < KB; ++e) {
#pragma unroll
                for (int i = 0; i < RT; ++i) {
                    acc[i][0] = fmaf(hc[i][e], wc[e].x, acc[i][0]);
                    acc[i][1] = fmaf(hc[i][e], wc[e].y, acc[i][1]);
                    acc[i][2] = fmaf(hc[i][e], wc[e].z, acc[i][2]);
                    acc[i][3] = fmaf(hc[i][e], wc[e].w, acc[i][3]);
                }
            }
#pragma unroll
            for (int e = 0; e < KB; ++e) {
                wc[e] = wnext[e];
#pragma unroll
                for (int i = 0; i < RT; ++i) hc[i][e] = hnext[i][e];
            }
        }
        PHASE_MARK(c2);
        float* hn = hs + (size_t)(s ^ 1) * R * H;
#pragma unroll
        for (int i = 0; i < RT; ++i) {
            const float pi = add<T>(xv[i][0], Num<T>::round(acc[i][0])), pf = add<T>(xv[i][1], Num<T>::round(acc[i][1]));
            const float pg = add<T>(xv[i][2], Num<T>::round(acc[i][2])), po = add<T>(xv[i][3], Num<T>::round(acc[i][3]));
            const float new_c = add<T>(mul<T>(sigmoid_t<T>(add<T>(pf, 1.0f)), c[i]), mul<T>(sigmoid_t<T>(pi), tanh_t<T>(pg)));
            const float new_h = mul<T>(sigmoid_t<T>(po), tanh_t<T>(new_c));
            const bool reset = rv[i] > 0.0f;
            const int r = r0 + i;
            if (r < live) {
                outs[((size_t)t * B + b0 + r) * H + j] = new_h;
                hn[r * H + j] = reset ? 0.0f : new_h;
            }
            c[i] = reset ? 0.0f : new_c;
        }
        PHASE_MARK(c3);
        __syncthreads();  // the new carry is whole
        PHASE_MARK(c4);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
            rv[i] = rn[i];
#pragma unroll
            for (int g = 0; g < 4; ++g) xv[i][g] = xn[i][g];
        }
        PHASE_ADD(0, c1, c2);  // the product
        PHASE_ADD(1, c2, c3);  // the cells
        PHASE_ADD(2, c0, c1);  // the next step's loads issued
        PHASE_ADD(3, c3, c4);  // the barrier
    }

    const float* hl = hs + (size_t)(steps & 1) * R * H;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
        const int r = r0 + i;
        if (r < live) {
            hc_final[(size_t)(b0 + r) * 2 * H + j] = hl[r * H + j];
            hc_final[(size_t)(b0 + r) * 2 * H + H + j] = c[i];
        }
    }
}

template <typename T, int RT>
__global__ void __launch_bounds__(kResidentThreads) lstm_resident_bwd_kernel(const BwdArgs<T> p, const float* __restrict__ wh, int R) {
    const int H = p.H, GH = 4 * H, WS = GH + 4, B = p.B, steps = p.steps, tid = threadIdx.x, nt = blockDim.x;
    const int j = tid % H, r0 = tid / H * RT;  // this thread's unit (of the cells and of dh) and its first row
    const int b0 = static_cast<int>(blockIdx.x) * R, live = min(R, B - b0);

    extern __shared__ __align__(16) unsigned char resident_smem[];
    float* ws = reinterpret_cast<float*>(resident_smem);  // [H][4H + 4]
    float* dg0 = reinterpret_cast<float*>(resident_smem + align16(4 * (size_t)H * WS));  // [2][R][4H]
    const int sdg = static_cast<int>(align16(4 * (size_t)R * GH) / 4);

    // wh into its padded rows, 16 bytes a copy (the wrapper passes wh on 16 bytes)
    for (int i = tid; i < H * (GH / 4); i += nt) {
        const int k = i / (GH / 4), q = i - k * (GH / 4);
        cp_async16(ws + (size_t)k * WS + 4 * q, wh + (size_t)k * GH + 4 * q);
    }
    cp_async_commit();
    for (int i = tid; i < 2 * sdg; i += nt) dg0[i] = 0.0f;  // rows past B stay zero in both buffers

    // the cell state entering each step, as the forward computed it, into cbuf (each cell its own thread's, which reads it
    // back below), unless the forward saved it there
    float c[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) c[i] = r0 + i < live ? Num<T>::round(p.s[(size_t)(b0 + r0 + i) * 2 * H + H + j]) : 0.0f;
    for (int t0 = 0; t0 < (p.cells_given ? 0 : steps); t0 += kResidentAhead) {
        float pi[kResidentAhead][RT], pf[kResidentAhead][RT], pg[kResidentAhead][RT], rst[kResidentAhead][RT];
#pragma unroll
        for (int u = 0; u < kResidentAhead; ++u) {
#pragma unroll
            for (int i = 0; i < RT; ++i) {
                const bool in = t0 + u < steps && r0 + i < live;
                const size_t row = (size_t)(t0 + u) * B + b0 + r0 + i;
                const T* pr = p.a + row * GH + j;
                pi[u][i] = in ? Num<T>::load(pr) : 0.0f, pf[u][i] = in ? Num<T>::load(pr + H) : 0.0f;
                pg[u][i] = in ? Num<T>::load(pr + 2 * H) : 0.0f, rst[u][i] = in ? p.resets[row] : 0.0f;
            }
        }
#pragma unroll
        for (int u = 0; u < kResidentAhead; ++u) {
#pragma unroll
            for (int i = 0; i < RT; ++i) {
                if (t0 + u < steps && r0 + i < live) p.cbuf[((size_t)(t0 + u) * B + b0 + r0 + i) * H + j] = c[i];
                const float new_c = add<T>(mul<T>(sig_bwd<T>(add<T>(pf[u][i], 1.0f)).s, c[i]),
                                           mul<T>(sig_bwd<T>(pi[u][i]).s, tanh_t<T>(pg[u][i])));
                c[i] = rst[u][i] > 0.0f ? 0.0f : new_c;
            }
        }
    }

    // a step's inputs of this thread's cells (proj's four gates, c, d_outs, the reset), zero past B; cbuf is this thread's own
    auto load = [&](int t, float (&av)[RT][4], float (&cv)[RT], float (&dv)[RT], float (&rv)[RT]) {
#pragma unroll
        for (int i = 0; i < RT; ++i) {
            const bool in = t >= 0 && r0 + i < live;
            const size_t row = (size_t)t * B + b0 + r0 + i;
#pragma unroll
            for (int g = 0; g < 4; ++g) av[i][g] = in ? Num<T>::load(p.a + row * GH + g * H + j) : 0.0f;
            cv[i] = in ? p.cbuf[row * H + j] : 0.0f;
            dv[i] = in ? p.d_outs[row * H + j] : 0.0f;
            rv[i] = in ? p.resets[row] : 0.0f;
        }
    };
    float av[RT][4], cv[RT], dv[RT], rv[RT];
    load(steps - 1, av, cv, dv, rv);
    float dh[RT], dc[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {  // no d_final: the final state's cotangent is zero
        const bool in = r0 + i < live && p.d_final != nullptr;
        dh[i] = in ? p.d_final[(size_t)(b0 + r0 + i) * 2 * H + j] : 0.0f;
        dc[i] = in ? p.d_final[(size_t)(b0 + r0 + i) * 2 * H + H + j] : 0.0f;
    }
    cp_async_wait<0>();
    __syncthreads();  // wh has landed; dg is zero

    for (int t = steps - 1; t >= 0; --t) {
        const int s = t & 1;
        PHASE_MARK(c1);
        float* g_out = dg0 + s * sdg;
#pragma unroll
        for (int i = 0; i < RT; ++i) {
            const float fa = add<T>(av[i][1], 1.0f);
            const Sig si = sig_bwd<T>(av[i][0]), sf = sig_bwd<T>(fa), so = sig_bwd<T>(av[i][3]);
            const float tg = tanh_t<T>(av[i][2]);
            const float tc = tanh_t<T>(add<T>(mul<T>(sf.s, cv[i]), mul<T>(si.s, tg)));
            const bool keep = !(rv[i] > 0.0f);
            const float gh = dv[i] + (keep ? dh[i] : 0.0f), gc = keep ? dc[i] : 0.0f;
            const float dct = gc + gh * so.s * (1.0f - tc * tc);
            const float dai = dct * tg * si.ds, daf = dct * cv[i] * sf.ds, dag = dct * si.s * (1.0f - tg * tg), dao = gh * tc * so.ds;
            dc[i] = dct * sf.s;
            const int r = r0 + i;
            if (r < live) {
                const size_t o = ((size_t)t * B + b0 + r) * GH + j;
                p.da[o] = Num<T>::to(dai), p.da[o + H] = Num<T>::to(daf), p.da[o + 2 * H] = Num<T>::to(dag), p.da[o + 3 * H] = Num<T>::to(dao);
                float* go = g_out + r * GH + j;
                go[0] = dai, go[H] = daf, go[2 * H] = dag, go[3 * H] = dao;
            }
        }
        PHASE_MARK(c2);
        __syncthreads();  // dg of step t is whole
        PHASE_MARK(c0);
        float an[RT][4], cn[RT], dn[RT], rn[RT];
        load(t - 1, an, cn, dn, rn);  // in flight while the product runs
        PHASE_MARK(c3);
        // the product: four partial sums a row; columns q + 4's reads issued before columns q's FMAs
        float acc[RT][4];
#pragma unroll
        for (int i = 0; i < RT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
        const float* w = ws + (size_t)j * WS;
        const float* d = g_out + r0 * GH;
        float4 wc = *reinterpret_cast<const float4*>(w), gc[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i) gc[i] = *reinterpret_cast<const float4*>(d + i * GH);  // a broadcast
#pragma unroll 2
        for (int q = 0; q < GH; q += 4) {
            const int qn = q + 4 < GH ? q + 4 : q;
            const float4 wn = *reinterpret_cast<const float4*>(w + qn);
            float4 gn[RT];
#pragma unroll
            for (int i = 0; i < RT; ++i) {
                gn[i] = *reinterpret_cast<const float4*>(d + i * GH + qn);
                acc[i][0] = fmaf(gc[i].x, wc.x, acc[i][0]);
                acc[i][1] = fmaf(gc[i].y, wc.y, acc[i][1]);
                acc[i][2] = fmaf(gc[i].z, wc.z, acc[i][2]);
                acc[i][3] = fmaf(gc[i].w, wc.w, acc[i][3]);
            }
            wc = wn;
#pragma unroll
            for (int i = 0; i < RT; ++i) gc[i] = gn[i];
        }
#pragma unroll
        for (int i = 0; i < RT; ++i) {
            dh[i] = (acc[i][0] + acc[i][1]) + (acc[i][2] + acc[i][3]);
            cv[i] = cn[i], dv[i] = dn[i], rv[i] = rn[i];
#pragma unroll
            for (int g = 0; g < 4; ++g) av[i][g] = an[i][g];
        }
        PHASE_MARK(c4);
        PHASE_ADD(0, c3, c4);  // the product
        PHASE_ADD(1, c1, c2);  // the cells
        PHASE_ADD(2, c0, c3);  // the next step's loads issued
        PHASE_ADD(3, c2, c0);  // the barrier
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
        const int r = r0 + i;
        if (r < live) {
            p.d_state0[(size_t)(b0 + r) * 2 * H + j] = dh[i];
            p.d_state0[(size_t)(b0 + r) * 2 * H + H + j] = dc[i];
        }
    }
}

// ------------------------------------------------------------------ design "resident", the input product folded in

// x's row in a block's shared memory: I rounded up to 4 (float4 reads), zero in the padding; wi's packed rows are padded alike
__host__ __device__ constexpr int resident_in_pad(int I) { return (I + 3) / 4 * 4; }

// Dynamic shared memory of one lstm_resident_in_kernel block; ops/cuda_rnn.py:resident_in_smem is the same formula, each part on
// 16 bytes: wh packed as [H][H][4] f32, wi packed as [Ip][H][4] f32, the carry h [2][R][H] f32, x of all `steps` steps
// [steps][R][Ip] f32, the input parts [2][R][H][4] f32, and for bf16 (`elem` 2) wh and wi as given ([H][4H] and [I][4H]), the
// landing place of their copies (f32 copies land in the packed parts themselves and are packed there, row by row).
inline size_t resident_in_smem_bytes(int H, int R, int I, int steps, int elem) {
    const size_t Ip = resident_in_pad(I), GH = 4 * static_cast<size_t>(H);
    return align16(16 * static_cast<size_t>(H) * H) + align16(16 * Ip * H) + align16(8 * static_cast<size_t>(R) * H) +
           align16(4 * static_cast<size_t>(steps) * R * Ip) + align16(32 * static_cast<size_t>(R) * H) +
           (elem == 2 ? align16(2 * H * GH) + align16(2 * I * GH) : 0);
}

template <typename T>
struct InArgs {
    const T* x;           // [steps][B][I] at strides sxt, sxb (elements), unit stride along I
    const T* wi;          // [I][4H], as given
    const T* bi;          // [4H]
    const float* hc0;     // [B][2H]
    const float* resets;  // [steps][B]
    const T* wh;          // [H][4H], as given
    float* outs;          // [steps][B][H]
    float* hc_final;      // [B][2H]
    T* proj;              // the backward's inputs, all three or none: the gate pre-activations [steps][B][4H],
    float* cells;         // the cell state entering each step [steps][B][H],
    T* xh;                // and [x | the carry h entering each step | 1 | 0 ...] [steps][B][K]
    long long sxt, sxb;
    int steps, B, H, I, K;
};

// rows of w as given ([rows][4H], landed in shared memory at src) into the packed layout [rows][H][4] f32 at dst (row k, unit j,
// gate g), a warp a row: each lane reads the four gates of its units (j = lane, lane + 32; H 32 or 64), neighbouring units across
// the warp, then writes each unit's four as one 16-byte store; the warp has read the whole row before it writes, so src may
// be dst (an f32 row packed in place).
template <typename T>
__device__ __forceinline__ void pack_rows(float* dst, const T* src, int rows, int H) {
    const int lane = threadIdx.x & 31, warps = blockDim.x / 32;
    for (int k = threadIdx.x / 32; k < rows; k += warps) {
        const T* w = src + (size_t)k * 4 * H;
        float v[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int g = 0; g < 4; ++g) v[u][g] = lane + 32 * u < H ? Num<T>::load(w + g * H + lane + 32 * u) : 0.0f;
        __syncwarp();
#pragma unroll
        for (int u = 0; u < 2; ++u)
            if (lane + 32 * u < H)
                *reinterpret_cast<float4*>(dst + ((size_t)k * H + lane + 32 * u) * 4) = make_float4(v[u][0], v[u][1], v[u][2], v[u][3]);
        __syncwarp();
    }
}

// x of every step of the block's rows into xs [steps][R][Ip] f32, zero past B and in the padding, loads issued eight at a time
// before their stores; where the backward's buffers are wanted, also those rows' x and constant columns (1, then zeros) of xh.
template <typename T>
__device__ __forceinline__ void stage_x(const InArgs<T>& p, float* xs, int b0, int live, int R) {
    const int Ip = resident_in_pad(p.I), n = p.steps * R * Ip;
    for (int i0 = threadIdx.x; i0 < n; i0 += 8 * blockDim.x) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            const int i = i0 + u * blockDim.x, k = i % Ip, r = i / Ip % R, t = i / (Ip * R);
            v[u] = i < n && r < live && k < p.I ? Num<T>::load(p.x + t * p.sxt + (b0 + r) * p.sxb + k) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            const int i = i0 + u * blockDim.x, k = i % Ip, r = i / Ip % R, t = i / (Ip * R);
            if (i >= n) break;
            xs[i] = v[u];
            if (p.xh != nullptr && r < live && k < p.I) p.xh[((size_t)t * p.B + b0 + r) * p.K + k] = Num<T>::to(v[u]);
        }
    }
    if (p.xh != nullptr) {
        const int C = p.K - p.I - p.H;
        for (int i = threadIdx.x; i < p.steps * R * C; i += blockDim.x) {
            const int q = i % C, r = i / C % R, t = i / (C * R);
            if (r < live) p.xh[((size_t)t * p.B + b0 + r) * p.K + p.I + p.H + q] = Num<T>::to(q == 0 ? 1.0f : 0.0f);
        }
    }
}

// The input part of one step for RT rows (xr: the first of them in xs) of unit j: x @ wi over k in order, rounded to T, then
// + bi in T, as the unfused route rounds it (its Linear's product, then its add).
template <typename T, int RT>
__device__ __forceinline__ void input_part(const float* xr, const float* wis, const float (&b)[4], int Ip, int H, int j, float (&xp)[RT][4]) {
    float acc[RT][4];
#pragma unroll
    for (int i = 0; i < RT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
    const float* w = wis + 4 * j;
#pragma unroll 2
    for (int k = 0; k < Ip; k += 4) {
        float4 xv[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i) xv[i] = *reinterpret_cast<const float4*>(xr + i * Ip + k);  // a broadcast
        float4 wv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) wv[e] = *reinterpret_cast<const float4*>(w + (size_t)(k + e) * 4 * H);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
            const float xe[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                acc[i][0] = fmaf(xe[e], wv[e].x, acc[i][0]);
                acc[i][1] = fmaf(xe[e], wv[e].y, acc[i][1]);
                acc[i][2] = fmaf(xe[e], wv[e].z, acc[i][2]);
                acc[i][3] = fmaf(xe[e], wv[e].w, acc[i][3]);
            }
        }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int g = 0; g < 4; ++g) xp[i][g] = add<T>(Num<T>::round(acc[i][g]), b[g]);
}

// lstm_resident_in_forward <- _lstm_kernel (sample_factory_tpu/ops/pallas_gru.py:226-253, pallas_call at :271) with the input
// product that the JAX package computes before it (sample_factory_tpu/ops/rnn_cells.py:124), counted as lstm_seq_resident_in:
// the LSTM from the raw input x [T,B,I], wi [I,4H] and bi [4H] in one launch, as cuDNN's LSTM call takes it. The resident
// design (lstm_resident_kernel's blocks, thread map, product and cells), with x_proj made in the block, off the recurrence's
// chain:
//   - the block has twice the resident forward's threads: consumers (tid < nc = R / RT * H), which run the recurrence as
//     lstm_resident_kernel does, and as many producers, producer q making the input parts of consumer q's cells: during step t
//     it computes step t + 1's, round_T(x @ wi) + bi in T (as the unfused route rounds it: its Linear's product, then its
//     add), into one of two shared buffers ([2][R][H][4] f32, each consumer's float4 of a row at its own index: no bank
//     conflict), which the consumers read after the step's barrier. The producers' FMAs and shared-memory reads fill the
//     consumers' waits on the product's shared-memory latency. On an H100, made at the top of each step by the consumers
//     themselves the input part cost about 750 cycles a step at DMLab's learner (rnn_seq_phases), and made for all steps in a
//     prologue it was slower still (0.0886 ms against 0.0803 a launch, in turns);
//   - wh and wi are read as given ([K][4H] in T): copied 16 bytes at a time into shared memory as they are, then laid out
//     packed ([K][H][4] f32, a thread's four gate weights of a row in one 16-byte read) by the block's warps, a row each, f32
//     rows in place (pack_rows; H 32 or 64), so that no launch of the wrapper packs them (4-byte copies of each element into the
//     packed layout cost 0.033 ms a launch on an H100);
//   - x of all T steps of the block's rows is staged in shared memory once ([T][R][Ip] f32: 10 KB at DMLab's learner); x is
//     read by element at its strides (the instruction encoder's x is a transposed view), so no copy of it and no alignment is
//     needed;
//   - where the backward's buffers are wanted (a call that needs a gradient), the consumers also write the gate
//     pre-activations proj (the backward kernel's input, so the backward's prologue and its product go) and the cell state
//     entering each step (so the backward's cell-state pass goes), and xh = [x | the carry h entering each step | 1 | 0 ...]
//     is filled, from which one product gives the gradients of wi, wh and bi; under no_grad (the rollout, the last value) the
//     block writes none.
template <typename T, int RT>
__global__ void __launch_bounds__(kResidentThreads) lstm_resident_in_kernel(const InArgs<T> p, int R) {
    const int H = p.H, GH = 4 * H, I = p.I, Ip = resident_in_pad(I), steps = p.steps, tid = threadIdx.x;
    const int nc = blockDim.x / 2;  // the consumers; the producers are the rest
    const bool consumer = tid < nc;
    const int q = consumer ? tid : tid - nc;
    const int j = q % H, r0 = q / H * RT;  // this thread's (or its consumer's) unit and first row
    const int b0 = static_cast<int>(blockIdx.x) * R, live = min(R, p.B - b0);
    const bool saving = p.proj != nullptr;

    extern __shared__ __align__(16) unsigned char resident_smem[];
    float* ws = reinterpret_cast<float*>(resident_smem);  // [H][H][4]
    float* wis = ws + align16(16 * (size_t)H * H) / 4;    // [Ip][H][4]
    float* hs = wis + align16(16 * (size_t)Ip * H) / 4;   // [2][R][H]
    float* xs = hs + align16(8 * (size_t)R * H) / 4;      // [steps][R][Ip]
    float4* xq = reinterpret_cast<float4*>(xs + align16(4 * (size_t)steps * R * Ip) / 4);  // [2][RT][nc]
    // wh and wi as given ([H][4H], [I][4H]): an f32 copy lands where it is packed, a bf16 one after the input parts
    T* whr = sizeof(T) == 4 ? reinterpret_cast<T*>(ws) : reinterpret_cast<T*>(xq + 2 * (size_t)R * H);
    T* wir = sizeof(T) == 4 ? reinterpret_cast<T*>(wis)
                            : reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(whr) + align16(sizeof(T) * (size_t)H * GH));

    stage_copy(whr, p.wh, static_cast<int>(sizeof(T)) * H * GH);
    stage_copy(wir, p.wi, static_cast<int>(sizeof(T)) * I * GH);
    cp_async_commit();
    stage_x(p, xs, b0, live, R);
    float b[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) b[g] = Num<T>::load(p.bi + g * H + j);
    // the carry is only ever used as a T operand, so it is kept rounded to T; rows past B stay zero
    for (int i = tid; i < 2 * R * H; i += blockDim.x) {
        const int r = i / H % R, k = i % H;
        hs[i] = i < R * H && r < live ? Num<T>::round(p.hc0[(size_t)(b0 + r) * 2 * H + k]) : 0.0f;
    }
    float c[RT], rv[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
        const int r = r0 + i;
        c[i] = r < live ? Num<T>::round(p.hc0[(size_t)(b0 + r) * 2 * H + H + j]) : 0.0f;
        rv[i] = r < live ? p.resets[b0 + r] : 0.0f;
        if (consumer && saving && r < live) p.xh[(size_t)(b0 + r) * p.K + I + j] = Num<T>::to(Num<T>::round(p.hc0[(size_t)(b0 + r) * 2 * H + j]));
    }
    cp_async_wait<0>();
    __syncthreads();  // wh and wi have landed as given, x is staged
    pack_rows(ws, whr, H, H);
    pack_rows(wis, wir, I, H);
    for (int i = tid; i < (Ip - I) * 4 * H; i += blockDim.x) wis[(size_t)I * 4 * H + i] = 0.0f;  // wi's padding rows
    __syncthreads();  // and are packed
    // the producers: step `t`'s input parts of their consumers' cells into buffer t & 1
    auto produce = [&](int t) {
        float xp[RT][4];
        input_part<T, RT>(xs + ((size_t)t * R + r0) * Ip, wis, b, Ip, H, j, xp);
#pragma unroll
        for (int i = 0; i < RT; ++i) xq[((size_t)(t & 1) * RT + i) * nc + q] = make_float4(xp[i][0], xp[i][1], xp[i][2], xp[i][3]);
    };
    if (!consumer) produce(0);
    __syncthreads();  // step 0's input parts are in buffer 0

    for (int t = 0; t < steps; ++t) {
        const int s = t & 1;
        if (!consumer) {
            if (t + 1 < steps) produce(t + 1);
        } else {
            PHASE_MARK(c0);
            float rn[RT], xv[RT][4];  // the next step's resets, in flight while this step runs; this step's input parts
#pragma unroll
            for (int i = 0; i < RT; ++i) {
                rn[i] = t + 1 < steps && r0 + i < live ? p.resets[(size_t)(t + 1) * p.B + b0 + r0 + i] : 0.0f;
                const float4 v = xq[((size_t)s * RT + i) * nc + q];
                xv[i][0] = v.x, xv[i][1] = v.y, xv[i][2] = v.z, xv[i][3] = v.w;
            }
            PHASE_MARK(c1);
            // the product, as lstm_resident_kernel's
            constexpr int KB = resident_kb<RT>();
            float acc[RT][4];
#pragma unroll
            for (int i = 0; i < RT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
            const float* hr = hs + (size_t)s * R * H + r0 * H;
            const float* w = ws + 4 * j;
            float4 wc[KB];
            float hc[RT][KB];
            auto chunk = [&](int k0, float4 (&wd)[KB], float (&hd)[RT][KB]) {
#pragma unroll
                for (int e = 0; e < KB; ++e) {
                    wd[e] = *reinterpret_cast<const float4*>(w + (size_t)(k0 + e) * GH);
#pragma unroll
                    for (int i = 0; i < RT; ++i) hd[i][e] = hr[i * H + k0 + e];  // a broadcast
                }
            };
            chunk(0, wc, hc);
            for (int k0 = 0; k0 < H; k0 += KB) {
                float4 wnext[KB];
                float hnext[RT][KB];
                chunk(k0 + KB < H ? k0 + KB : k0, wnext, hnext);
#pragma unroll
                for (int e = 0; e < KB; ++e) {
#pragma unroll
                    for (int i = 0; i < RT; ++i) {
                        acc[i][0] = fmaf(hc[i][e], wc[e].x, acc[i][0]);
                        acc[i][1] = fmaf(hc[i][e], wc[e].y, acc[i][1]);
                        acc[i][2] = fmaf(hc[i][e], wc[e].z, acc[i][2]);
                        acc[i][3] = fmaf(hc[i][e], wc[e].w, acc[i][3]);
                    }
                }
#pragma unroll
                for (int e = 0; e < KB; ++e) {
                    wc[e] = wnext[e];
#pragma unroll
                    for (int i = 0; i < RT; ++i) hc[i][e] = hnext[i][e];
                }
            }
            PHASE_MARK(c2);
            float* hn = hs + (size_t)(s ^ 1) * R * H;
#pragma unroll
            for (int i = 0; i < RT; ++i) {
                const float pi = add<T>(xv[i][0], Num<T>::round(acc[i][0])), pf = add<T>(xv[i][1], Num<T>::round(acc[i][1]));
                const float pg = add<T>(xv[i][2], Num<T>::round(acc[i][2])), po = add<T>(xv[i][3], Num<T>::round(acc[i][3]));
                const float new_c = add<T>(mul<T>(sigmoid_t<T>(add<T>(pf, 1.0f)), c[i]), mul<T>(sigmoid_t<T>(pi), tanh_t<T>(pg)));
                const float new_h = mul<T>(sigmoid_t<T>(po), tanh_t<T>(new_c));
                const bool reset = rv[i] > 0.0f;
                const int r = r0 + i;
                if (r < live) {
                    const size_t row = (size_t)t * p.B + b0 + r;
                    p.outs[row * H + j] = new_h;
                    hn[r * H + j] = reset ? 0.0f : new_h;
                    if (saving) {
                        T* pr = p.proj + row * GH + j;
                        pr[0] = Num<T>::to(pi), pr[H] = Num<T>::to(pf), pr[2 * H] = Num<T>::to(pg), pr[3 * H] = Num<T>::to(po);
                        p.cells[row * H + j] = c[i];
                        if (t + 1 < steps) p.xh[(row + p.B) * p.K + I + j] = Num<T>::to(reset ? 0.0f : new_h);
                    }
                }
                c[i] = reset ? 0.0f : new_c;
                rv[i] = rn[i];
            }
            PHASE_MARK(c3);
            PHASE_ADD(0, c1, c2);  // the product
            PHASE_ADD(1, c2, c3);  // the cells
            PHASE_ADD(2, c0, c1);  // the next step's resets issued, this step's input parts read
        }
        PHASE_MARK(c4);
        __syncthreads();  // the new carry is whole, and the next step's input parts are made
        PHASE_MARK(c5);
        PHASE_ADD(3, c4, c5);  // the barrier (thread 0, a consumer: its wait for the producers too)
    }

    if (consumer) {
        const float* hl = hs + (size_t)(steps & 1) * R * H;
#pragma unroll
        for (int i = 0; i < RT; ++i) {
            const int r = r0 + i;
            if (r < live) {
                p.hc_final[(size_t)(b0 + r) * 2 * H + j] = hl[r * H + j];
                p.hc_final[(size_t)(b0 + r) * 2 * H + H + j] = c[i];
            }
        }
    }
}

// Launch a resident kernel of R rows and `threads` threads a block, ceil(B / R) blocks; the shared-memory limit above 48 KB
// raised once per kernel, device and process (as launch_bwd raises it).
template <typename K, typename... Args>
int launch_resident(K kernel, int B, int R, int threads, int smem, cudaStream_t stream, Args... args) {
    static std::mutex lock;
    static std::map<std::pair<const void*, int>, int> smem_set;  // (kernel, device) -> the limit set there
    {
        std::lock_guard<std::mutex> guard(lock);
        int dev = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err != cudaSuccess) return failed(err);
        int& set = smem_set[{reinterpret_cast<const void*>(kernel), dev}];
        if (smem > 48 * 1024 && smem > set) {
            err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (err != cudaSuccess) return failed(err);
            set = smem;
        }
    }
    kernel<<<(B + R - 1) / R, threads, smem, stream>>>(args...);
    return static_cast<int>(cudaGetLastError());
}

// The checks both resident launchers make: H a multiple of 8 (the forward product's chunks of k, float4 reads of dg and of
// wh's rows), at most kResidentThreads threads, and the plan's shared memory equal to the kernel's formula.
inline bool resident_shape_ok(int steps, int B, int H, int R, size_t smem, size_t want) {
    return steps >= 1 && B >= 1 && H >= 8 && H % 8 == 0 && R >= 1 && R / resident_rows_a_thread(R, H) * H <= kResidentThreads &&
           smem == want;
}

template <typename T>
int resident_forward(const void* x, const void* hc0, const void* resets, const void* wpk, void* outs, void* hc_final, int steps, int B,
                     int H, int R, int smem, cudaStream_t stream) {
    if (!resident_shape_ok(steps, B, H, R, smem, resident_smem_bytes(H, R))) return static_cast<int>(cudaErrorInvalidValue);
    const T* xt = static_cast<const T*>(x);
    const float *s0 = static_cast<const float*>(hc0), *rs = static_cast<const float*>(resets), *w = static_cast<const float*>(wpk);
    float *o = static_cast<float*>(outs), *sf = static_cast<float*>(hc_final);
    switch (resident_rows_a_thread(R, H)) {
        case 4: return launch_resident(lstm_resident_kernel<T, 4>, B, R, R / 4 * H, smem, stream, xt, s0, rs, w, o, sf, steps, B, H, R);
        case 2: return launch_resident(lstm_resident_kernel<T, 2>, B, R, R / 2 * H, smem, stream, xt, s0, rs, w, o, sf, steps, B, H, R);
        default: return launch_resident(lstm_resident_kernel<T, 1>, B, R, R / 1 * H, smem, stream, xt, s0, rs, w, o, sf, steps, B, H, R);
    }
}

template <typename T>
int resident_in_forward(const InArgs<T>& p, int R, int smem, cudaStream_t stream) {
    const bool saved = p.proj != nullptr;
    const int rt = resident_rows_a_thread(R, p.H);
    if (!resident_shape_ok(p.steps, p.B, p.H, R, smem, resident_in_smem_bytes(p.H, R, p.I, p.steps, sizeof(T))) || p.H % 32 != 0 || p.H > 64 ||
        2 * (R / rt) * p.H > kResidentThreads || p.I < 1 || saved != (p.cells != nullptr) || saved != (p.xh != nullptr) ||
        (saved && p.K < p.I + p.H + 1))
        return static_cast<int>(cudaErrorInvalidValue);
    const int threads = 2 * (R / rt) * p.H;  // the consumers' and as many producers
    switch (rt) {
        case 4: return launch_resident(lstm_resident_in_kernel<T, 4>, p.B, R, threads, smem, stream, p, R);
        case 2: return launch_resident(lstm_resident_in_kernel<T, 2>, p.B, R, threads, smem, stream, p, R);
        default: return launch_resident(lstm_resident_in_kernel<T, 1>, p.B, R, threads, smem, stream, p, R);
    }
}

template <typename T>
int resident_backward(const BwdArgs<T>& p, const float* wh, int R, int smem, cudaStream_t stream) {
    if (!resident_shape_ok(p.steps, p.B, p.H, R, smem, resident_bwd_smem_bytes(p.H, R))) return static_cast<int>(cudaErrorInvalidValue);
    switch (resident_rows_a_thread(R, p.H)) {
        case 4: return launch_resident(lstm_resident_bwd_kernel<T, 4>, p.B, R, R / 4 * p.H, smem, stream, p, wh, R);
        case 2: return launch_resident(lstm_resident_bwd_kernel<T, 2>, p.B, R, R / 2 * p.H, smem, stream, p, wh, R);
        default: return launch_resident(lstm_resident_bwd_kernel<T, 1>, p.B, R, R / 1 * p.H, smem, stream, p, wh, R);
    }
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

// Clusters of `cluster` blocks with `smem` bytes each that the current card runs at once (0 if none);
// at smem = the opt-in limit, one block an SM (ops/cuda_rnn.py:card_spec).
int max_active_clusters(int gates, int is_bf16, int cluster, int smem) {
    auto query = [&](auto kernel) {
        cudaFuncAttributes attrs;  // raise the limit only: launch_cluster remembers the largest it set
        if (cudaFuncGetAttributes(&attrs, kernel) != cudaSuccess) return 0;
        if (attrs.maxDynamicSharedSizeBytes < smem) cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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

// Design "grid" (f32): wpk is wh packed by ops/cuda_rnn.py:pack_wh as [H/units][G*units][H]; hbuf is
// a [2][B][H] f32 scratch buffer; a thread's register tile is tile_rows x tile_cols (4 x 4 or 8 x 8).
int gru_grid_forward(const void* x, const void* h0, const void* resets, const void* wpk, const void* bh, void* hbuf,
                     void* outs, void* h_final, int steps, int B, int H, int units, int rows, int tile_rows, int tile_cols,
                     int ksplit, int kchunk, int passes, int threads, int smem, void* stream) {
    return grid_forward<GruCells>(x, h0, resets, wpk, bh, hbuf, outs, h_final, steps, B, H, units, rows, tile_rows,
                                  tile_cols, ksplit, kchunk, passes, threads, smem, stream);
}

int lstm_grid_forward(const void* x, const void* hc0, const void* resets, const void* wpk, void* hbuf, void* outs,
                      void* hc_final, int steps, int B, int H, int units, int rows, int tile_rows, int tile_cols,
                      int ksplit, int kchunk, int passes, int threads, int smem, void* stream) {
    return grid_forward<LstmCells>(x, hc0, resets, wpk, nullptr, hbuf, outs, hc_final, steps, B, H, units, rows, tile_rows,
                                   tile_cols, ksplit, kchunk, passes, threads, smem, stream);
}

// Blocks of a grid-design kernel (of `gates` 3: the GRU's, 4: the LSTM's) with `threads` threads and
// `smem` bytes that one SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor; 0 if none).
int grid_blocks_per_sm(int gates, int tile_rows, int tile_cols, int threads, int smem) {
    auto query = [&](auto kernel) {
        cudaFuncAttributes attrs;  // raise the limit only: launch_grid remembers the largest it set
        if (cudaFuncGetAttributes(&attrs, kernel) != cudaSuccess) return 0;
        if (attrs.maxDynamicSharedSizeBytes < smem) cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        int n = 0;
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem) == cudaSuccess ? n : 0;
    };
    if (tile_rows == 4 && tile_cols == 4) return gates == 3 ? query(grid_kernel<GruCells, 4, 4>) : query(grid_kernel<LstmCells, 4, 4>);
    if (tile_rows == 8 && tile_cols == 8) return gates == 3 ? query(grid_kernel<GruCells, 8, 8>) : query(grid_kernel<LstmCells, 8, 8>);
    return 0;
}

#ifdef RNN_SEQ_PHASES
int rnn_seq_phases_read(void* out) {
    return static_cast<int>(cudaMemcpyFromSymbol(out, rnn_seq_phase_cycles, sizeof(rnn_seq_phase_cycles)));
}
int rnn_seq_phases_reset() {
    const unsigned long long zero[5] = {};
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

// Backward (BPTT) of the GRU, reverse time: wt is wh^T [3H][H], packed by ops/cuda_rnn.py once a call; rows is
// the batch rows of a block (1, 2, 4 or 8: ops/cuda_rnn.py:bwd_rows), smem bwd_smem_bytes(3, H, rows, elem).
int gru_seq_backward(const void* d_outs, const void* d_h_final, const void* resets, const void* x, const void* h_proj,
                     const void* h_prev, const void* wt, void* d_x, void* d_hn, void* d_h0, int steps, int B, int H,
                     int is_bf16, int rows, int smem, void* stream) {
    return seq_backward_typed<3>(d_outs, d_h_final, resets, x, h_proj, h_prev, wt, nullptr, d_x, d_hn, d_h0, steps, B, H,
                                 is_bf16, rows, smem, stream);
}

// Backward of the LSTM: proj = x_proj + h_prev @ wh; cbuf a [steps][B][H] f32 scratch buffer for the cell state
// the kernel recomputes; d_proj is d_x_proj, and also the cotangent of h_prev @ wh.
int lstm_seq_backward(const void* d_outs, const void* d_hc_final, const void* resets, const void* proj, const void* hc0,
                      const void* wt, void* cbuf, void* d_proj, void* d_hc0, int steps, int B, int H, int is_bf16, int rows,
                      int smem, void* stream) {
    return seq_backward_typed<4>(d_outs, d_hc_final, resets, proj, nullptr, hc0, wt, cbuf, d_proj, nullptr, d_hc0, steps, B,
                                 H, is_bf16, rows, smem, stream);
}

// Backward, design "grid" (float32): wh as given, [H][G*H]; the plan (ops/cuda_rnn.py:bwd_grid_plan) gives `units` a
// slice, `rows` a batch tile, the K splits, the K chunk, the passes, the threads and smem =
// bwd_grid_smem_bytes(G, H, units, rows, ksplit, kchunk, passes). d_h0 / d_hc0 also carry the cells' cotangents
// between the steps.
int gru_seq_grid_backward(const void* d_outs, const void* d_h_final, const void* resets, const void* x, const void* h_proj,
                          const void* h_prev, const void* wh, void* d_x, void* d_hn, void* d_h0, int steps, int B, int H, int units,
                          int rows, int ksplit, int kchunk, int passes, int threads, int smem, void* stream) {
    const BwdArgs<float> p{static_cast<const float*>(d_outs), static_cast<const float*>(d_h_final), static_cast<const float*>(resets),
                           static_cast<const float*>(x), static_cast<const float*>(h_proj), static_cast<const float*>(h_prev),
                           static_cast<const float*>(wh), nullptr, static_cast<float*>(d_x), static_cast<float*>(d_hn),
                           static_cast<float*>(d_h0), steps, B, H};
    return launch_bwd_grid<GruBwdCells>(p, units, rows, ksplit, kchunk, passes, threads, smem, stream);
}

int lstm_seq_grid_backward(const void* d_outs, const void* d_hc_final, const void* resets, const void* proj, const void* hc0,
                           const void* wh, void* cbuf, void* d_proj, void* d_hc0, int steps, int B, int H, int units, int rows,
                           int ksplit, int kchunk, int passes, int threads, int smem, void* stream) {
    const BwdArgs<float> p{static_cast<const float*>(d_outs), static_cast<const float*>(d_hc_final), static_cast<const float*>(resets),
                           static_cast<const float*>(proj), nullptr, static_cast<const float*>(hc0), static_cast<const float*>(wh),
                           static_cast<float*>(cbuf), static_cast<float*>(d_proj), nullptr, static_cast<float*>(d_hc0), steps, B, H};
    return launch_bwd_grid<LstmBwdCells>(p, units, rows, ksplit, kchunk, passes, threads, smem, stream);
}

// Blocks of the grid backward kernel (of `gates` 3: the GRU's, 4: the LSTM's) with `threads` threads and `smem` bytes
// that one SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor; 0 if none).
int grid_bwd_blocks_per_sm(int gates, int threads, int smem) {
    auto query = [&](auto kernel) {
        cudaFuncAttributes attrs;  // raise the limit only: launch_bwd_grid remembers the largest it set
        int n = 0;
        if (cudaFuncGetAttributes(&attrs, kernel) != cudaSuccess ||
            (attrs.maxDynamicSharedSizeBytes < smem && cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess) ||
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem) != cudaSuccess) {
            (void)cudaGetLastError();  // none fits; no error is left for the next launch
            return 0;
        }
        return n;
    };
    return gates == 3 ? query(seq_bwd_grid_kernel<GruBwdCells>) : query(seq_bwd_grid_kernel<LstmBwdCells>);
}

// Backward, design "cluster": wpk is wh packed by ops/cuda_rnn.py:pack_wh as [cluster][3*U][H], the forward's slices; the plan
// (ops/cuda_rnn.py:bwd_cluster_plan) gives the blocks a cluster, the batch rows a cluster, the receive buffers (1 or 2) and
// smem = bwd_cluster_smem_bytes(3, H, cluster, rows, elem, buffers). The GRU's d_hn as gru_seq_backward's.
int gru_seq_cluster_backward(const void* d_outs, const void* d_h_final, const void* resets, const void* x, const void* h_proj,
                             const void* h_prev, const void* wpk, void* d_x, void* d_hn, void* d_h0, int steps, int B, int H,
                             int is_bf16, int cluster, int rows, int buffers, int smem, void* stream) {
    return cluster_backward_typed<3>(d_outs, d_h_final, resets, x, h_proj, h_prev, wpk, nullptr, d_x, d_hn, d_h0, steps, B, H,
                                     is_bf16, cluster, rows, buffers, smem, stream);
}

// Backward of the LSTM, design "cluster": proj and cbuf as lstm_seq_backward's, wpk as gru_seq_cluster_backward's.
int lstm_seq_cluster_backward(const void* d_outs, const void* d_hc_final, const void* resets, const void* proj, const void* hc0,
                              const void* wpk, void* cbuf, void* d_proj, void* d_hc0, int steps, int B, int H, int is_bf16,
                              int cluster, int rows, int buffers, int smem, void* stream) {
    return cluster_backward_typed<4>(d_outs, d_hc_final, resets, proj, nullptr, hc0, wpk, cbuf, d_proj, nullptr, d_hc0, steps, B, H,
                                     is_bf16, cluster, rows, buffers, smem, stream);
}

// Clusters of the cluster backward kernel (of `gates` 3: the GRU's, 4: the LSTM's) of `cluster` blocks with `smem` bytes
// each that the current card runs at once (cudaOccupancyMaxActiveClusters; 0 if none).
int bwd_max_active_clusters(int gates, int is_bf16, int cluster, int smem) {
    auto query = [&](auto kernel) {
        cudaFuncAttributes attrs;  // raise the limit only: launch_bwd_cluster remembers the largest it set
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
        if (cudaFuncGetAttributes(&attrs, kernel) != cudaSuccess ||
            (attrs.maxDynamicSharedSizeBytes < smem && cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess) ||
            cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) != cudaSuccess ||
            cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) {
            (void)cudaGetLastError();  // none fits; no error is left for the next launch
            return 0;
        }
        return n;
    };
    if (gates == 3) return is_bf16 ? query(seq_bwd_cluster_kernel<__nv_bfloat16, 3>) : query(seq_bwd_cluster_kernel<float, 3>);
    return is_bf16 ? query(seq_bwd_cluster_kernel<__nv_bfloat16, 4>) : query(seq_bwd_cluster_kernel<float, 4>);
}

// Design "resident" (the LSTM): wpk is wh packed by ops/cuda_rnn.py:pack_wh as [H][H][4] f32 (a bf16 wh converted, exactly),
// on 16 bytes; rows the batch rows of a block (ops/cuda_rnn.py:resident_plan), smem resident_smem_bytes(H, rows).
int lstm_resident_forward(const void* x, const void* hc0, const void* resets, const void* wpk, void* outs, void* hc_final, int steps,
                          int B, int H, int is_bf16, int rows, int smem, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return is_bf16 ? resident_forward<__nv_bfloat16>(x, hc0, resets, wpk, outs, hc_final, steps, B, H, rows, smem, s)
                   : resident_forward<float>(x, hc0, resets, wpk, outs, hc_final, steps, B, H, rows, smem, s);
}

// Backward of the LSTM, design "resident": lstm_seq_backward's arguments, with wh [H][4H] in f32 on 16 bytes in place of wh^T,
// and smem resident_bwd_smem_bytes(H, rows).
int lstm_seq_resident_backward(const void* d_outs, const void* d_hc_final, const void* resets, const void* proj, const void* hc0,
                               const void* wh, void* cbuf, void* d_proj, void* d_hc0, int steps, int B, int H, int is_bf16, int rows,
                               int smem, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    auto args = [&](auto* typed) {
        using T = std::remove_const_t<std::remove_pointer_t<decltype(typed)>>;
        return BwdArgs<T>{static_cast<const float*>(d_outs), static_cast<const float*>(d_hc_final), static_cast<const float*>(resets),
                          static_cast<const T*>(proj), nullptr, static_cast<const float*>(hc0), nullptr, static_cast<float*>(cbuf),
                          static_cast<T*>(d_proj), nullptr, static_cast<float*>(d_hc0), steps, B, H};
    };
    const float* w = static_cast<const float*>(wh);
    if (is_bf16) return resident_backward<__nv_bfloat16>(args(static_cast<__nv_bfloat16*>(nullptr)), w, rows, smem, st);
    return resident_backward<float>(args(static_cast<float*>(nullptr)), w, rows, smem, st);
}

// The LSTM from its raw input, design "resident" with the input product folded in (lstm_resident_in_kernel): x [steps][B][I] at
// strides sxt, sxb (elements; unit stride along I), wi [I][4H], bi [4H] and wh [H][4H] as given in T; proj, cells and xh (K
// columns) all null under no_grad, else the backward's buffers; rows and smem from ops/cuda_rnn.py:resident_in_plan, smem
// resident_in_smem_bytes(H, rows, I, steps, the element's bytes); twice the resident forward's threads.
int lstm_resident_in_forward(const void* x, const void* wi, const void* bi, const void* hc0, const void* resets, const void* wh,
                             void* outs, void* hc_final, void* proj, void* cells, void* xh, long long sxt, long long sxb, int steps,
                             int B, int H, int I, int K, int is_bf16, int rows, int smem, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    auto args = [&](auto* typed) {
        using T = std::remove_const_t<std::remove_pointer_t<decltype(typed)>>;
        return InArgs<T>{static_cast<const T*>(x), static_cast<const T*>(wi), static_cast<const T*>(bi), static_cast<const float*>(hc0),
                         static_cast<const float*>(resets), static_cast<const T*>(wh), static_cast<float*>(outs),
                         static_cast<float*>(hc_final), static_cast<T*>(proj), static_cast<float*>(cells), static_cast<T*>(xh),
                         sxt, sxb, steps, B, H, I, K};
    };
    if (is_bf16) return resident_in_forward(args(static_cast<__nv_bfloat16*>(nullptr)), rows, smem, st);
    return resident_in_forward(args(static_cast<float*>(nullptr)), rows, smem, st);
}

// Backward of lstm_resident_in_forward: lstm_seq_resident_backward on the buffers the forward saved, proj and the cell states
// (cells: its cell-state pass skipped); d_hc_final may be null (a zero cotangent).
int lstm_seq_resident_in_backward(const void* d_outs, const void* d_hc_final, const void* resets, const void* proj, const void* hc0,
                                  const void* wh, const void* cells, void* d_proj, void* d_hc0, int steps, int B, int H, int is_bf16,
                                  int rows, int smem, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    auto args = [&](auto* typed) {
        using T = std::remove_const_t<std::remove_pointer_t<decltype(typed)>>;
        return BwdArgs<T>{static_cast<const float*>(d_outs), static_cast<const float*>(d_hc_final), static_cast<const float*>(resets),
                          static_cast<const T*>(proj), nullptr, static_cast<const float*>(hc0), nullptr,
                          const_cast<float*>(static_cast<const float*>(cells)), static_cast<T*>(d_proj), nullptr,
                          static_cast<float*>(d_hc0), steps, B, H, true};
    };
    const float* w = static_cast<const float*>(wh);
    if (is_bf16) return resident_backward<__nv_bfloat16>(args(static_cast<__nv_bfloat16*>(nullptr)), w, rows, smem, st);
    return resident_backward<float>(args(static_cast<float*>(nullptr)), w, rows, smem, st);
}

}  // extern "C"
