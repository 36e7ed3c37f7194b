// Fused router gate: row softmax over E logits, then k rounds of argmax with
// the lowest index winning ties, then optional renormalization.
//
// Replaces the Pallas kernel repro/kernels/topk_gate.py:_topk_kernel
// (pallas_call at topk_gate.py:93). Bound on this card: bytes. Each row reads
// E f32 logits once and writes k ids and k weights; the k rounds of argmax
// run over a copy of the row in shared memory, so nothing but the inputs and
// outputs touches device memory. One warp per row, 4 rows per block.
#include "common.cuh"

using namespace repro;

constexpr int TK_WARPS = 4;

__global__ void topk_gate_kernel(const float* __restrict__ logits, int T, int E, int k,
                                 int normalize, int32_t* __restrict__ ids,
                                 float* __restrict__ weights) {
    extern __shared__ float smem[];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int row = blockIdx.x * TK_WARPS + warp;
    if (row >= T) return;
    float* p = smem + warp * E;
    const float* x = logits + (size_t)row * E;

    float m = -INFINITY;
    for (int e = lane; e < E; e += 32) {
        const float v = x[e];
        p[e] = v;
        m = fmaxf(m, v);
    }
    m = warp_max(m);
    float s = 0.f;
    for (int e = lane; e < E; e += 32) {
        const float v = expf(p[e] - m);
        p[e] = v;
        s += v;
    }
    s = warp_sum(s);
    for (int e = lane; e < E; e += 32) p[e] = p[e] / s;
    __syncwarp();

    float wsum = 0.f;
    for (int r = 0; r < k; ++r) {
        float best = -INFINITY;
        int bi = E;
        for (int e = lane; e < E; e += 32) {      // ascending e: '>' keeps the lowest
            const float v = p[e];
            if (v > best) { best = v; bi = e; }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float ob = __shfl_xor_sync(0xffffffffu, best, off);
            const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
            if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
        }
        if (lane == 0) {
            ids[(size_t)row * k + r] = bi;
            weights[(size_t)row * k + r] = best;
        }
        wsum += best;
        __syncwarp();
        if (bi < E && (bi % 32) == lane) p[bi] = -1.0f;   // taken: below every prob
        __syncwarp();
    }
    if (normalize && lane == 0) {
        const float d = fmaxf(wsum, 1e-9f);
        for (int r = 0; r < k; ++r) weights[(size_t)row * k + r] /= d;
    }
}

extern "C" int topk_gate_f32(const void* logits, int T, int E, int k, int normalize,
                             void* ids, void* weights, void* stream) {
    const size_t smem = (size_t)TK_WARPS * E * sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            topk_gate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid((T + TK_WARPS - 1) / TK_WARPS);
    topk_gate_kernel<<<grid, 32 * TK_WARPS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(logits), T, E, k, normalize,
        static_cast<int32_t*>(ids), static_cast<float*>(weights));
    return (int)cudaGetLastError();
}
