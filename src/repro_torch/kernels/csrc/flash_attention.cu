// Flash attention for prefill: causal, optional sliding window and tanh
// soft-cap, grouped-query (q head h reads KV head h / g), online softmax,
// KV tiles that no query of the tile can reach skipped.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:_flash_kernel
// (pallas_call at flash_attention.py:114). q is [B, Sq, H, dh], k/v
// [B, Skv, Hkv, dh], out [B, Sq, H, dh], all in the model's layout.
//
// Bound on this card: operations (512 positions x 32 heads x dh 128 is about
// 4.3 GFLOP per layer with the causal half skipped, against 6 MB of q/k/v/out).
// The TPU carried the softmax state across sequential grid steps in VMEM; here
// one block owns a 64-row query tile of one head and loops over the KV tiles
// itself, with the running max, sum and 64 x dh accumulator in registers
// (4 rows x dh/16 columns per thread) and Q, K, V and the probability tile in
// shared memory (about 115 KB, so the block asks for dynamic shared memory
// above 48 KB). CUDA cores only; a TMA + wgmma pipeline is later work.
#include "common.cuh"

using namespace repro;

constexpr int FA_B = 64;        // query rows and key rows per tile
constexpr int FA_THREADS = 256;
constexpr int FA_MAXDC = 8;     // dh / 16 <= 8, i.e. head_dim <= 128

template <typename T>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ out, int Sq, int Skv, int H, int Hkv, int dh, float scale,
          int causal, int window, float soft_cap) {
    extern __shared__ float smem[];
    const int ld = dh + 1;
    float* Qs = smem;                   // [FA_B, ld]
    float* Ks = Qs + FA_B * ld;         // [FA_B, ld]
    float* Vs = Ks + FA_B * ld;         // [FA_B, dh]
    float* Ps = Vs + FA_B * dh;         // [FA_B, FA_B + 1]
    const int q0 = blockIdx.x * FA_B, h = blockIdx.y, b = blockIdx.z;
    const int g = H / Hkv, hk = h / g;
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int dc = dh / 16;

    for (int i = tid; i < FA_B * dh; i += FA_THREADS) {
        const int r = i / dh, d = i % dh, s = q0 + r;
        Qs[r * ld + d] = s < Sq ? to_f(q[(((size_t)b * Sq + s) * H + h) * dh + d]) : 0.f;
    }
    float m[4], l[4], o[4][FA_MAXDC];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        m[r] = NEG_INF;
        l[r] = 0.f;
#pragma unroll
        for (int c = 0; c < FA_MAXDC; ++c) o[r][c] = 0.f;
    }
    const int q_last = min(q0 + FA_B, Sq) - 1;
    for (int k0 = 0; k0 < Skv; k0 += FA_B) {
        if (causal && k0 > q_last) break;                          // every later tile too
        if (window > 0 && k0 + FA_B - 1 <= q0 - window) continue;  // behind the window
        __syncthreads();                  // the previous tile's readers are done
        for (int i = tid; i < FA_B * dh; i += FA_THREADS) {
            const int r = i / dh, d = i % dh, s = k0 + r;
            const size_t src = (((size_t)b * Skv + s) * Hkv + hk) * dh + d;
            Ks[r * ld + d] = s < Skv ? to_f(k[src]) : 0.f;
            Vs[r * dh + d] = s < Skv ? to_f(v[src]) : 0.f;
        }
        __syncthreads();
        float sc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) sc[r][c] = 0.f;
        for (int d = 0; d < dh; ++d) {
            float a[4], bb[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) a[r] = Qs[(ty + 16 * r) * ld + d];
#pragma unroll
            for (int c = 0; c < 4; ++c) bb[c] = Ks[(tx + 16 * c) * ld + d];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c) sc[r][c] += a[r] * bb[c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int qpos = q0 + ty + 16 * r;
            bool ok[4];
            float mx = NEG_INF;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int kpos = k0 + tx + 16 * c;
                float s = sc[r][c] * scale;
                if (soft_cap > 0.f) s = soft_cap * tanhf(s / soft_cap);
                bool valid = kpos < Skv;
                if (causal) valid = valid && kpos <= qpos;
                if (window > 0) valid = valid && kpos > qpos - window;
                ok[c] = valid;
                sc[r][c] = valid ? s : NEG_INF;
                mx = fmaxf(mx, sc[r][c]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)     // the 16 lanes sharing a row
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[r], mx);
            const float corr = expf(m[r] - m_new);
            float rs = 0.f;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const float p = ok[c] ? expf(sc[r][c] - m_new) : 0.f;
                Ps[(ty + 16 * r) * (FA_B + 1) + tx + 16 * c] = p;
                rs += p;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                rs += __shfl_xor_sync(0xffffffffu, rs, off);
            l[r] = l[r] * corr + rs;
            m[r] = m_new;
#pragma unroll
            for (int c = 0; c < FA_MAXDC; ++c) o[r][c] *= corr;
        }
        __syncthreads();
        for (int j = 0; j < FA_B; ++j) {
            float vv[FA_MAXDC];
#pragma unroll
            for (int c = 0; c < FA_MAXDC; ++c) vv[c] = c < dc ? Vs[j * dh + tx + 16 * c] : 0.f;
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const float pp = Ps[(ty + 16 * r) * (FA_B + 1) + j];
#pragma unroll
                for (int c = 0; c < FA_MAXDC; ++c) o[r][c] += pp * vv[c];
            }
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int qpos = q0 + ty + 16 * r;
        if (qpos >= Sq) continue;
        const float inv_l = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
        for (int c = 0; c < FA_MAXDC; ++c) {
            if (c < dc) {
                const int d = tx + 16 * c;
                out[(((size_t)b * Sq + qpos) * H + h) * dh + d] = from_f<T>(o[r][c] * inv_l);
            }
        }
    }
}

template <typename T>
static int launch_flash(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                        int Skv, int H, int Hkv, int dh, float scale, int causal, int window,
                        float soft_cap, void* stream) {
    const size_t smem = (size_t)(2 * FA_B * (dh + 1) + FA_B * dh + FA_B * (FA_B + 1)) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Sq + FA_B - 1) / FA_B, H, B);
    flash_fwd<T><<<grid, FA_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(out), Sq, Skv, H, Hkv, dh, scale, causal, window, soft_cap);
    return (int)cudaGetLastError();
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int B, int Sq, int Skv, int H, int Hkv, int dh, float scale,
                                    int causal, int window, float soft_cap, void* stream) {
    return launch_flash<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, Hkv, dh, scale, causal,
                                       window, soft_cap, stream);
}

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                   int B, int Sq, int Skv, int H, int Hkv, int dh, float scale,
                                   int causal, int window, float soft_cap, void* stream) {
    return launch_flash<float>(q, k, v, out, B, Sq, Skv, H, Hkv, dh, scale, causal, window,
                               soft_cap, stream);
}
