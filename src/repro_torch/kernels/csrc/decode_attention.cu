// Flash-decode: one query token per row against a contiguous KV cache, the
// g query heads of a KV head scored together, per-row valid lengths, an
// optional tanh soft-cap and an online softmax.
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py:_decode_kernel
// (pallas_call at decode_attention.py:108). q is [B, H, dh], the cache k/v
// [B, S, Hkv, dh] (the model's layout, read in place), lengths [B] the valid
// positions per row (cur_len + 1: the new token is written before scoring).
//
// Bound on this card: bytes (each valid K and V element is read once). On the
// TPU the KV axis was a sequential grid dimension; here B * Hkv is small at
// decode (4 at batch 1 for the paper's model), so the KV axis is SPLIT across
// blocks: each block scores a 64-position chunk for all g heads of one KV head
// and writes its partial (max, sum, unnormalized context), and a second
// kernel merges the partials. Chunks past a row's length exit at once, so the
// bytes read follow the valid length, not the cache capacity.
#include "common.cuh"

using namespace repro;

constexpr int DA_CHUNK = 64;
constexpr int DA_THREADS = 128;
constexpr int DA_MAXG = 16;

template <typename T>
__global__ void __launch_bounds__(DA_THREADS)
decode_partial(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const int32_t* __restrict__ lengths, int H, int Hkv, int S, int dh,
               float scale, float soft_cap, float* __restrict__ m_out,
               float* __restrict__ l_out, float* __restrict__ acc_out) {
    extern __shared__ float smem[];
    const int g = H / Hkv;
    const int bh = blockIdx.x, b = bh / Hkv, hk = bh % Hkv;
    const int split = blockIdx.y, nsplit = gridDim.y;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int nwarps = DA_THREADS / 32;
    const size_t part = (size_t)bh * nsplit + split;
    const int len = lengths[b];
    const int start = split * DA_CHUNK;
    if (start >= len) {                       // nothing valid: an empty partial
        for (int i = tid; i < g * dh; i += DA_THREADS) acc_out[part * g * dh + i] = 0.f;
        if (tid < g) { m_out[part * g + tid] = NEG_INF; l_out[part * g + tid] = 0.f; }
        return;
    }
    float* qs = smem;                         // [g, dh]
    float* ss = smem + g * dh;                // [g, DA_CHUNK] scores, then probs
    __shared__ float mh[DA_MAXG], lh[DA_MAXG];
    for (int i = tid; i < g * dh; i += DA_THREADS) {
        const int h = i / dh, d = i % dh;
        qs[i] = to_f(q[((size_t)b * H + hk * g + h) * dh + d]);
    }
    __syncthreads();
    const int n = min(DA_CHUNK, S - start);
    for (int j = warp; j < n; j += nwarps) {
        const int pos = start + j;
        const T* kr = k + (((size_t)b * S + pos) * Hkv + hk) * dh;
        float a[DA_MAXG];
#pragma unroll
        for (int h = 0; h < DA_MAXG; ++h) a[h] = 0.f;
        for (int d = lane; d < dh; d += 32) {
            const float kv = to_f(kr[d]);
#pragma unroll
            for (int h = 0; h < DA_MAXG; ++h)
                if (h < g) a[h] += qs[h * dh + d] * kv;
        }
#pragma unroll
        for (int h = 0; h < DA_MAXG; ++h) {
            if (h < g) {
                float s = warp_sum(a[h]) * scale;
                if (soft_cap > 0.f) s = soft_cap * tanhf(s / soft_cap);
                if (pos >= len) s = NEG_INF;
                if (lane == 0) ss[h * DA_CHUNK + j] = s;
            }
        }
    }
    __syncthreads();
    for (int h = warp; h < g; h += nwarps) {
        float m = NEG_INF;
        for (int j = lane; j < n; j += 32) m = fmaxf(m, ss[h * DA_CHUNK + j]);
        m = warp_max(m);
        float l = 0.f;
        for (int j = lane; j < n; j += 32) {
            const float p = expf(ss[h * DA_CHUNK + j] - m);
            ss[h * DA_CHUNK + j] = p;
            l += p;
        }
        l = warp_sum(l);
        if (lane == 0) { mh[h] = m; lh[h] = l; }
    }
    __syncthreads();
    for (int d = tid; d < dh; d += DA_THREADS) {
        float a[DA_MAXG];
#pragma unroll
        for (int h = 0; h < DA_MAXG; ++h) a[h] = 0.f;
        for (int j = 0; j < n; ++j) {
            const float vv = to_f(v[(((size_t)b * S + start + j) * Hkv + hk) * dh + d]);
#pragma unroll
            for (int h = 0; h < DA_MAXG; ++h)
                if (h < g) a[h] += ss[h * DA_CHUNK + j] * vv;
        }
#pragma unroll
        for (int h = 0; h < DA_MAXG; ++h)
            if (h < g) acc_out[(part * g + h) * dh + d] = a[h];
    }
    if (tid < g) { m_out[part * g + tid] = mh[tid]; l_out[part * g + tid] = lh[tid]; }
}

template <typename T>
__global__ void decode_combine(const float* __restrict__ m_in, const float* __restrict__ l_in,
                               const float* __restrict__ acc_in, int H, int Hkv, int nsplit,
                               int dh, T* __restrict__ out) {
    const int row = blockIdx.x;               // b * H + h
    const int b = row / H, h = row % H, g = H / Hkv;
    const int hk = h / g, hg = h % g;
    const size_t base = (size_t)(b * Hkv + hk) * nsplit;
    float M = NEG_INF;
    for (int s = 0; s < nsplit; ++s) M = fmaxf(M, m_in[(base + s) * g + hg]);
    float L = 0.f;
    for (int s = 0; s < nsplit; ++s)
        L += expf(m_in[(base + s) * g + hg] - M) * l_in[(base + s) * g + hg];
    const float inv_l = 1.f / fmaxf(L, 1e-30f);
    for (int d = threadIdx.x; d < dh; d += blockDim.x) {
        float o = 0.f;
        for (int s = 0; s < nsplit; ++s)
            o += expf(m_in[(base + s) * g + hg] - M) * acc_in[((base + s) * g + hg) * dh + d];
        out[(size_t)row * dh + d] = from_f<T>(o * inv_l);
    }
}

template <typename T>
static int launch_decode(const void* q, const void* k, const void* v, const void* lengths,
                         int B, int H, int Hkv, int S, int dh, float scale, float soft_cap,
                         void* m_ws, void* l_ws, void* acc_ws, void* out, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int g = H / Hkv;
    const int nsplit = (S + DA_CHUNK - 1) / DA_CHUNK;
    const size_t smem = (size_t)(g * dh + g * DA_CHUNK) * sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            decode_partial<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    decode_partial<T><<<dim3(B * Hkv, nsplit), DA_THREADS, smem, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const int32_t*>(lengths), H, Hkv, S, dh, scale, soft_cap,
        static_cast<float*>(m_ws), static_cast<float*>(l_ws), static_cast<float*>(acc_ws));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    decode_combine<T><<<B * H, 128, 0, st>>>(
        static_cast<const float*>(m_ws), static_cast<const float*>(l_ws),
        static_cast<const float*>(acc_ws), H, Hkv, nsplit, dh, static_cast<T*>(out));
    return (int)cudaGetLastError();
}

extern "C" int decode_attention_chunk() { return DA_CHUNK; }

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* lengths, int B, int H, int Hkv, int S, int dh,
                                     float scale, float soft_cap, void* m_ws, void* l_ws,
                                     void* acc_ws, void* out, void* stream) {
    return launch_decode<__nv_bfloat16>(q, k, v, lengths, B, H, Hkv, S, dh, scale, soft_cap,
                                        m_ws, l_ws, acc_ws, out, stream);
}

extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    const void* lengths, int B, int H, int Hkv, int S, int dh,
                                    float scale, float soft_cap, void* m_ws, void* l_ws,
                                    void* acc_ws, void* out, void* stream) {
    return launch_decode<float>(q, k, v, lengths, B, H, Hkv, S, dh, scale, soft_cap,
                                m_ws, l_ws, acc_ws, out, stream);
}
