// Flash attention for prefill: causal, optional sliding window and tanh
// soft-cap, grouped-query (q head h reads KV head h / g), online softmax,
// KV tiles that no query of the tile can reach skipped.
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:_flash_kernel
// (pallas_call at flash_attention.py:114). q is [B, Sq, H, dh], k/v
// [B, Skv, Hkv, dh], out [B, Sq, H, dh], all in the model's layout.
//
// Bound on this card at the main path's shape (512 positions, 32 heads, 4 KV
// heads, dh 128, causal): bytes. The causal half is 2.15 GFLOP (4.3 GFLOP
// without the skip), 2.2 us at the bf16 tensor rate, against 9.4 MB of
// q/k/v/out, 2.8 us at 3.35 TB/s; the two are close, so the kernel has to
// keep the tensor cores busy and the loads overlapped to come near either.
//
// bf16 entry, the main path's body: tensor cores (mma.sync.m16n8k16, bf16
// operands, f32 accumulation; mma.sync rather than wgmma, whose descriptors
// buy little at 64-row tiles). A block of 4 warps owns a 64-row query tile of
// one head, 16 rows per warp, and loops over 64-row KV tiles itself:
//  * Q, K and V stay bf16 in shared memory, rows padded by 16 bytes so the
//    ldmatrix loads of the mma fragments are free of bank conflicts; up to
//    dh 128 Q's fragments are loaded into registers once, past it they are
//    loaded from shared memory for each KV tile (see below);
//  * K/V tiles arrive by cp.async into a ring of 2 stages: tile j+1 loads
//    while tile j is computed, and V_j while K_j is used; ragged rows are
//    zero-filled by the copy;
//  * S = Q K^T lands in registers; the online softmax runs on those
//    fragments (row max and sum across the 4 lanes of a quad, exp2 with the
//    log2(e) factor folded in), masks only tiles that cross the causal
//    diagonal, the window edge or the end of the keys, and P, rounded to
//    bf16, feeds P V as the A operand straight from registers (the Pallas
//    body's f32 dot rounds its operands to bf16 on the TPU's matrix unit);
//  * the grid runs the heaviest causal query tiles (the last ones) first;
//  * a query row that no key reaches (a window past the last key) gives
//    zeros;
//  * the output goes through the warp's own rows of the Q tile in shared
//    memory so each row leaves in 16-byte stores.
// The kernel is templated on dh, every multiple of 16 up to 256. What bounds
// the wide heads is registers: a warp's O accumulators are dh / 2 floats a
// thread (80 at dh 160, 128 at dh 256) beside 32 of S, so past dh 128 the
// Q fragments (dh / 4 registers) are not held but read again from shared
// memory for each tile (one ldmatrix per 16 columns, a quarter more shared
// loads than K's), which keeps the 160 and 256 instances free of spills.
// Shared memory is (64 + 4 x 64) x (dh + 8) bf16: 105 KB at dh 160 (two
// blocks an SM), 165 KB at dh 256 (one).
//
// f32 entry: the first port's CUDA-core body (f32 on tensor cores would be
// TF32, which the f32 tolerance rejects); f32 is not on the main path. It
// keeps dh / 16 accumulator columns a thread, up to 8 (dh 128) or 16 (dh
// 256), a template parameter.
//
// Chunk-append entries (chunked prefill, one CUDA graph per chunk length):
// the same two bodies with the C queries at absolute positions cur_len ..
// cur_len + C - 1 against the KV cache [B, cap, Hkv, dh] after the chunk's
// write (slot == position: the caller never lets a chunk wrap the cache),
// causal. ``cur_len`` is read on the device from an int64 scalar, so one
// captured launch serves every chunk start; the grid is sized from C alone
// and the key loop ends at the last live key (cur_len + C), so the unwritten
// slots past it are never read. A query row's sums run over 64-key tiles at
// absolute positions in one order, so its output does not depend on C or on
// where in its chunk it sits.
//
// Partial chunk entries (chunked prefill over a cache split by sequence over
// the tensor axis; K2's partial entry for C queries): the chunk's C queries
// at absolute positions cur_len .. cur_len + C - 1 (cur_len read on the
// device) against one slice k/v [B, S_loc, Hkv, dh] that holds positions
// offset .. offset + S_loc - 1, causal, no window. Out: f32 rows
// [B, C, H, dh + 1], each head's normalized context and then the natural
// log-sum-exp of its scores; a query that sees no key of the slice gives a
// zero context and -inf. The caller all-gathers the rows and merges them.
// bf16 runs the tensor-core body above with the slice's key offset (the
// causal mask and the last tile read compare absolute positions, so tiles
// past every query of a block are never loaded) and a second epilogue: the
// f32 context staged in the free K ring and stored row by row, and the lse
// as (m + log2 l) ln 2 from the base-2 running max and sum, -inf where l is
// 0 (no division by it). What bound the first body (scalar f32 FMAs over
// operands converted in shared memory, P V a key at a time, no
// asynchronous copies) is gone; what is left is the tensor-core body's
// (one block per query head, so the g heads of a KV head each load its
// tiles). f32 keeps a CUDA-core body (f32 operands on tensor cores would
// be TF32): 64 queries by 64 keys a tile, f32 sums.
#include "common.cuh"

using namespace repro;

// ---------------------------------------------------------------------------
// f32: CUDA cores, 64-row tiles in f32 shared memory
// ---------------------------------------------------------------------------
constexpr int FA_B = 64;        // query rows and key rows per tile
constexpr int FA_THREADS = 256;
constexpr int FA_MAXDH = 256;   // head_dim <= 256, a multiple of 16

template <int FA_MAXDC>         // dh / 16 <= FA_MAXDC
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, int Sq, int Skv, int H,
              int Hkv, int dh, float scale, int causal, int window, float soft_cap,
              const long long* __restrict__ q_off) {
    extern __shared__ float smem[];
    const int ld = dh + 1;
    float* Qs = smem;                   // [FA_B, ld]
    float* Ks = Qs + FA_B * ld;         // [FA_B, ld]
    float* Vs = Ks + FA_B * ld;         // [FA_B, dh]
    float* Ps = Vs + FA_B * dh;         // [FA_B, FA_B + 1]
    const int q0 = blockIdx.x * FA_B, h = blockIdx.y, b = blockIdx.z;
    const int qo = q_off ? (int)*q_off : 0;             // absolute position of query 0
    const int g = H / Hkv, hk = h / g;
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int dc = dh / 16;

    for (int i = tid; i < FA_B * dh; i += FA_THREADS) {
        const int r = i / dh, d = i % dh, s = q0 + r;
        Qs[r * ld + d] = s < Sq ? q[(((size_t)b * Sq + s) * H + h) * dh + d] : 0.f;
    }
    float m[4], l[4], o[4][FA_MAXDC];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        m[r] = NEG_INF;
        l[r] = 0.f;
#pragma unroll
        for (int c = 0; c < FA_MAXDC; ++c) o[r][c] = 0.f;
    }
    const int q_last = qo + min(q0 + FA_B, Sq) - 1;
    for (int k0 = 0; k0 < Skv; k0 += FA_B) {
        if (causal && k0 > q_last) break;                          // every later tile too
        if (window > 0 && k0 + FA_B - 1 <= qo + q0 - window) continue;  // behind the window
        __syncthreads();                  // the previous tile's readers are done
        for (int i = tid; i < FA_B * dh; i += FA_THREADS) {
            const int r = i / dh, d = i % dh, s = k0 + r;
            const size_t src = (((size_t)b * Skv + s) * Hkv + hk) * dh + d;
            Ks[r * ld + d] = s < Skv ? k[src] : 0.f;
            Vs[r * dh + d] = s < Skv ? v[src] : 0.f;
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
            const int qpos = qo + q0 + ty + 16 * r;
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
                out[(((size_t)b * Sq + qpos) * H + h) * dh + d] = o[r][c] * inv_l;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BM = 64;          // query rows per block, 16 per warp
constexpr int BN = 64;          // key rows per tile
constexpr int THREADS = BM / 16 * 32;
constexpr int PAD = 8;          // bf16 elements (16 bytes) of padding per shared row
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// rows [r0, r0 + 64) of a [rows, ld] bf16 matrix into a [64, DH + PAD] tile;
// rows at or past ``nrows`` read as zeros
template <int DH>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, size_t ld, int r0, int nrows,
                                          int tid) {
    constexpr int CH = DH / 8;
    for (int i = tid; i < 64 * CH; i += THREADS) {
        const int r = i / CH, c = i % CH;
        const bool ok = r0 + r < nrows;
        cp_async16(s + r * (DH + PAD) + c * 8, g + (size_t)(ok ? r0 + r : 0) * ld + c * 8, ok);
    }
}

// ``k_off``: the absolute position of key 0 (a slice of a cache split by
// sequence; 0 for a whole cache). ``partial``: the partial epilogue, f32 rows
// [B, Sq, H, DH + 1] (normalized context, then the natural lse) instead of
// bf16 [B, Sq, H, DH].
template <int DH>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          void* __restrict__ out, int Sq, int Skv, int H, int Hkv, float scale, int causal,
          int window, float soft_cap, const long long* __restrict__ q_off, int k_off,
          int partial) {
    constexpr int LDS = DH + PAD, KD = DH / 16, ND = DH / 8, NT = BN / 8;
    constexpr bool Q_REGS = DH <= 128;                  // Q's fragments held in registers
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);      // [BM, LDS]
    bf16* Ks = Qs + BM * LDS;                           // [2, BN, LDS]
    bf16* Vs = Ks + 2 * BN * LDS;                       // [2, BN, LDS]
    const int h = blockIdx.x, b = blockIdx.z;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // the heaviest causal tiles first
    const int hk = h / (H / Hkv);
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int gq = lane >> 2, t4 = lane & 3;            // quad (row) and lane in the quad
    const size_t ldq = (size_t)H * DH, ldk = (size_t)Hkv * DH;
    const bf16* qg = q + ((size_t)b * Sq * H + h) * DH;
    const bf16* kg = k + ((size_t)b * Skv * Hkv + hk) * DH;
    const bf16* vg = v + ((size_t)b * Skv * Hkv + hk) * DH;

    const int qo = q_off ? (int)*q_off : 0;             // absolute position of query 0
    const int q_first = qo + q0, q_last = qo + min(q0 + BM, Sq) - 1;
    // the local keys some query of the tile sees (absolute position k_off + j)
    const int k_end = causal ? min(Skv, q_last - k_off + 1) : Skv;
    const int k_begin = window > 0 ? max(0, q_first - window + 1 - k_off) / BN * BN : 0;
    const int n_tiles = k_end > k_begin ? (k_end - k_begin + BN - 1) / BN : 0;

    // commit groups in order: Q + K_0, V_0, K_1, V_1, ...
    load_tile<DH>(Qs, qg, ldq, q0, Sq, tid);
    if (n_tiles > 0) load_tile<DH>(Ks, kg, ldk, k_begin, Skv, tid);
    cp_async_commit();
    if (n_tiles > 0) load_tile<DH>(Vs, vg, ldk, k_begin, Skv, tid);
    cp_async_commit();

    uint32_t qf[Q_REGS ? KD : 1][4];
    float o[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    const int row0 = q_first + warp * 16 + gq;          // position of c0/c1; c2/c3 are row0 + 8

    for (int j = 0; j < n_tiles; ++j) {
        const int k0 = k_begin + j * BN;
        const int st = (j + 1) & 1;
        if (j + 1 < n_tiles) load_tile<DH>(Ks + st * BN * LDS, kg, ldk, k0 + BN, Skv, tid);
        cp_async_commit();
        if (j + 1 < n_tiles) load_tile<DH>(Vs + st * BN * LDS, vg, ldk, k0 + BN, Skv, tid);
        cp_async_commit();
        cp_async_wait<3>();                             // K_j (and Q) have landed
        __syncthreads();
        const bf16* Qw = Qs + (warp * 16 + (lane & 15)) * LDS + (lane >> 4) * 8;
        if constexpr (Q_REGS) {
            if (j == 0) {
#pragma unroll
                for (int kk = 0; kk < KD; ++kk) ldmatrix_x4(qf[kk], Qw + kk * 16);
            }
        }
        const bf16* Kt = Ks + (j & 1) * BN * LDS;
        const bf16* Vt = Vs + (j & 1) * BN * LDS;

        // S = Q K^T
        float s[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
            uint32_t qa[4];
            if constexpr (Q_REGS) {
#pragma unroll
                for (int e = 0; e < 4; ++e) qa[e] = qf[kk][e];
            } else {
                ldmatrix_x4(qa, Qw + kk * 16);
            }
#pragma unroll
            for (int nn = 0; nn < NT / 2; ++nn) {
                uint32_t kb[4];
                ldmatrix_x4(kb, Kt + (nn * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS + kk * 16
                                    + ((lane >> 3) & 1) * 8);
                mma(s[2 * nn], qa, kb[0], kb[1]);
                mma(s[2 * nn + 1], qa, kb[2], kb[3]);
            }
        }

        // scale, soft-cap, mask (only where the tile crosses an edge), row max
        const bool full = k0 + BN <= Skv && (!causal || k_off + k0 + BN - 1 <= q_first)
                          && (window <= 0 || k_off + k0 > q_last - window);
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = s[n][e] * scale;
                if (soft_cap > 0.f) x = soft_cap * tanhf(x / soft_cap);
                x *= LOG2E;
                if (!full) {
                    const int qpos = row0 + (e >> 1) * 8, kl = k0 + n * 8 + t4 * 2 + (e & 1);
                    const int kpos = k_off + kl;
                    bool valid = kl < Skv;
                    if (causal) valid = valid && kpos <= qpos;
                    if (window > 0) valid = valid && kpos > qpos - window;
                    if (!valid) x = NEG_INF;
                }
                s[n][e] = x;
                mx[e >> 1] = fmaxf(mx[e >> 1], x);
            }
        }
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            const float m_new = fmaxf(m[r], mx[r]);
            corr[r] = exp2f(m[r] - m_new);
            m[r] = m_new;
            l[r] *= corr[r];
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = e >> 1;
                const float p = s[n][e] > NEG_INF ? exp2f(s[n][e] - m[r]) : 0.f;
                l[r] += p;                               // this lane's share of the row sum
                s[n][e] = p;
            }
        }
#pragma unroll
        for (int n = 0; n < ND; ++n) {
            o[n][0] *= corr[0];
            o[n][1] *= corr[0];
            o[n][2] *= corr[1];
            o[n][3] *= corr[1];
        }

        // O += P V, P as the A operand from registers
        cp_async_wait<2>();                             // V_j has landed
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk) {
            const uint32_t a[4] = {
                pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
            for (int nd = 0; nd < DH / 16; ++nd) {
                uint32_t vb[4];
                ldmatrix_x4_trans(vb, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS
                                          + nd * 16 + (lane >> 4) * 8);
                mma(o[2 * nd], a, vb[0], vb[1]);
                mma(o[2 * nd + 1], a, vb[2], vb[3]);
            }
        }
        __syncthreads();                                 // stage j & 1 is free for tile j + 2
    }
    cp_async_wait<0>();
    __syncthreads();     // every thread's copies into Q have landed (no KV tile: none waited)

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
    if (partial) {
        // f32 context staged in the warp's share of the free K ring (4 x 16
        // rows of DH + 4 floats fit in its 2 x 64 x (DH + 8) bf16), then each
        // row's DH + 1 floats stored by neighbouring lanes; a row with no
        // visible key (l 0) gives zeros and lse -inf
        constexpr int LDO = DH + 4;
        float* Of = reinterpret_cast<float*>(Ks) + warp * 16 * LDO;
        float* pout = static_cast<float*>(out);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
            const int qpos = q0 + warp * 16 + gq + r * 8;
            if (t4 == 0 && qpos < Sq)
                pout[(((size_t)b * Sq + qpos) * H + h) * (DH + 1) + DH] =
                    l[r] > 0.f ? (m[r] + log2f(l[r])) * LN2 : __int_as_float(0xff800000);
        }
#pragma unroll
        for (int n = 0; n < ND; ++n) {
            *reinterpret_cast<float2*>(Of + gq * LDO + n * 8 + t4 * 2) =
                make_float2(o[n][0] * inv[0], o[n][1] * inv[0]);
            *reinterpret_cast<float2*>(Of + (gq + 8) * LDO + n * 8 + t4 * 2) =
                make_float2(o[n][2] * inv[1], o[n][3] * inv[1]);
        }
        __syncwarp();
        for (int i = lane; i < 16 * DH; i += 32) {
            const int r = i / DH, c = i % DH, qpos = q0 + warp * 16 + r;
            if (qpos < Sq)
                pout[(((size_t)b * Sq + qpos) * H + h) * (DH + 1) + c] = Of[r * LDO + c];
        }
        return;
    }
    // normalize, stage the warp's 16 rows in its own rows of the Q tile, store
    bf16* Os = Qs + warp * 16 * LDS;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
        *reinterpret_cast<uint32_t*>(Os + gq * LDS + n * 8 + t4 * 2) =
            pack_bf16(o[n][0] * inv[0], o[n][1] * inv[0]);
        *reinterpret_cast<uint32_t*>(Os + (gq + 8) * LDS + n * 8 + t4 * 2) =
            pack_bf16(o[n][2] * inv[1], o[n][3] * inv[1]);
    }
    __syncwarp();
    constexpr int CH = DH / 8;
    for (int i = lane; i < 16 * CH; i += 32) {
        const int r = i / CH, c = i % CH, qpos = q0 + warp * 16 + r;
        if (qpos < Sq)
            *reinterpret_cast<uint4*>(static_cast<bf16*>(out)
                                      + (((size_t)b * Sq + qpos) * H + h) * DH + c * 8) =
                *reinterpret_cast<const uint4*>(Os + r * LDS + c * 8);
    }
}

template <int DH>
static int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                  int Skv, int H, int Hkv, float scale, int causal, int window, float soft_cap,
                  const long long* q_off, int k_off, int partial, cudaStream_t stream) {
    const size_t smem = (size_t)(BM + 4 * BN) * (DH + PAD) * sizeof(bf16);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)            // shared memory for 2 blocks per SM
        err = cudaFuncSetAttribute(flash_fwd<DH>,
                                   cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(H, (Sq + BM - 1) / BM, B);
    flash_fwd<DH><<<grid, THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        out, Sq, Skv, H, Hkv, scale, causal, window, soft_cap, q_off, k_off, partial);
    return (int)cudaGetLastError();
}

}  // namespace tc

static int run_bf16(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                    int Skv, int H, int Hkv, int dh, float scale, int causal, int window,
                    float soft_cap, const long long* q_off, void* stream, int k_off = 0,
                    int partial = 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FA_DH_CASE(D)                                                                      \
    case D:                                                                                \
        return tc::launch<D>(q, k, v, out, B, Sq, Skv, H, Hkv, scale, causal, window,      \
                             soft_cap, q_off, k_off, partial, st);
    switch (dh) {
        FA_DH_CASE(16) FA_DH_CASE(32) FA_DH_CASE(48) FA_DH_CASE(64)
        FA_DH_CASE(80) FA_DH_CASE(96) FA_DH_CASE(112) FA_DH_CASE(128)
        FA_DH_CASE(144) FA_DH_CASE(160) FA_DH_CASE(176) FA_DH_CASE(192)
        FA_DH_CASE(208) FA_DH_CASE(224) FA_DH_CASE(240) FA_DH_CASE(256)
        default: return (int)cudaErrorInvalidValue;
    }
#undef FA_DH_CASE
}

static int run_f32(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                   int Skv, int H, int Hkv, int dh, float scale, int causal, int window,
                   float soft_cap, const long long* q_off, void* stream) {
    if (dh < 16 || dh % 16 || dh > FA_MAXDH) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)(2 * FA_B * (dh + 1) + FA_B * dh + FA_B * (FA_B + 1)) * sizeof(float);
    auto kernel = dh <= 128 ? flash_fwd_f32<8> : flash_fwd_f32<16>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Sq + FA_B - 1) / FA_B, H, B);
    kernel<<<grid, FA_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(out), Sq, Skv, H, Hkv, dh, scale, causal, window, soft_cap, q_off);
    return (int)cudaGetLastError();
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int B, int Sq, int Skv, int H, int Hkv, int dh, float scale,
                                    int causal, int window, float soft_cap, void* stream) {
    return run_bf16(q, k, v, out, B, Sq, Skv, H, Hkv, dh, scale, causal, window, soft_cap,
                    nullptr, stream);
}

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                   int B, int Sq, int Skv, int H, int Hkv, int dh, float scale,
                                   int causal, int window, float soft_cap, void* stream) {
    return run_f32(q, k, v, out, B, Sq, Skv, H, Hkv, dh, scale, causal, window, soft_cap,
                   nullptr, stream);
}

// The chunk-append entries: q [B, C, H, dh] at positions *cur_len + i
// (``cur_len`` an int64 on the device) against the cache k/v [B, cap, Hkv,
// dh], causal, the window and soft cap as above.
extern "C" int flash_attention_chunk_bf16(const void* q, const void* k, const void* v,
                                          void* out, const void* cur_len, int B, int C, int cap,
                                          int H, int Hkv, int dh, float scale, int window,
                                          float soft_cap, void* stream) {
    return run_bf16(q, k, v, out, B, C, cap, H, Hkv, dh, scale, 1, window, soft_cap,
                    static_cast<const long long*>(cur_len), stream);
}

extern "C" int flash_attention_chunk_f32(const void* q, const void* k, const void* v,
                                         void* out, const void* cur_len, int B, int C, int cap,
                                         int H, int Hkv, int dh, float scale, int window,
                                         float soft_cap, void* stream) {
    return run_f32(q, k, v, out, B, C, cap, H, Hkv, dh, scale, 1, window, soft_cap,
                   static_cast<const long long*>(cur_len), stream);
}

// ---------------------------------------------------------------------------
// f32 partial chunk entry: CUDA cores, f32 shared memory (the bf16 entry is
// the tensor-core body's partial epilogue)
// ---------------------------------------------------------------------------
namespace part {

constexpr int PB = 64;          // query rows and key rows per tile
constexpr int PT = 256;         // 16 x 16 threads: 4 query rows x 4 keys each

template <int MAXDC>            // dh / 16 <= MAXDC
__global__ void __launch_bounds__(PT)
chunk_partial(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v,
              float* __restrict__ out, const long long* __restrict__ cur_len, int C, int S,
              int H, int Hkv, int dh, int k_off, float scale, float soft_cap) {
    extern __shared__ float smem[];
    const int ld = dh + 1;
    float* Qs = smem;                   // [PB, ld]
    float* Ks = Qs + PB * ld;           // [PB, ld]
    float* Vs = Ks + PB * ld;           // [PB, dh]
    float* Ps = Vs + PB * dh;           // [PB, PB + 1]
    const int q0 = blockIdx.x * PB, h = blockIdx.y, b = blockIdx.z;
    const int cl = (int)*cur_len;       // absolute position of query 0
    const int hk = h / (H / Hkv);
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

    for (int i = tid; i < PB * dh; i += PT) {
        const int r = i / dh, d = i % dh, s = q0 + r;
        Qs[r * ld + d] = s < C ? q[(((size_t)b * C + s) * H + h) * dh + d] : 0.f;
    }
    float m[4], l[4], o[4][MAXDC];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        m[r] = NEG_INF;
        l[r] = 0.f;
#pragma unroll
        for (int c = 0; c < MAXDC; ++c) o[r][c] = 0.f;
    }
    // local keys some query of this tile sees: offset + j <= cl + last query
    const int k_end = min(S, cl + min(q0 + PB, C) - 1 - k_off + 1);
    for (int k0 = 0; k0 < k_end; k0 += PB) {
        __syncthreads();                  // the previous tile's readers are done
        for (int i = tid; i < PB * dh; i += PT) {
            const int r = i / dh, d = i % dh, s = k0 + r;
            const size_t src = (((size_t)b * S + s) * Hkv + hk) * dh + d;
            Ks[r * ld + d] = s < S ? k[src] : 0.f;
            Vs[r * dh + d] = s < S ? v[src] : 0.f;
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
            const int qpos = cl + q0 + ty + 16 * r;
            bool ok[4];
            float mx = NEG_INF;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int kl = k0 + tx + 16 * c;
                float s = sc[r][c] * scale;
                if (soft_cap > 0.f) s = soft_cap * tanhf(s / soft_cap);
                ok[c] = kl < S && k_off + kl <= qpos;
                sc[r][c] = ok[c] ? s : NEG_INF;
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
                Ps[(ty + 16 * r) * (PB + 1) + tx + 16 * c] = p;
                rs += p;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                rs += __shfl_xor_sync(0xffffffffu, rs, off);
            l[r] = l[r] * corr + rs;
            m[r] = m_new;
#pragma unroll
            for (int c = 0; c < MAXDC; ++c) o[r][c] *= corr;
        }
        __syncthreads();
        const int dc = dh / 16;
        for (int j = 0; j < PB; ++j) {
            float vv[MAXDC];
#pragma unroll
            for (int c = 0; c < MAXDC; ++c) vv[c] = c < dc ? Vs[j * dh + tx + 16 * c] : 0.f;
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const float pp = Ps[(ty + 16 * r) * (PB + 1) + j];
#pragma unroll
                for (int c = 0; c < MAXDC; ++c) o[r][c] += pp * vv[c];
            }
        }
    }
    const int dc = dh / 16;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int row = q0 + ty + 16 * r;
        if (row >= C) continue;
        const bool seen = l[r] > 0.f;
        const float inv_l = seen ? 1.f / l[r] : 0.f;
        float* dst = out + (((size_t)b * C + row) * H + h) * (dh + 1);
#pragma unroll
        for (int c = 0; c < MAXDC; ++c)
            if (c < dc) dst[tx + 16 * c] = o[r][c] * inv_l;
        if (tx == 0) dst[dh] = seen ? m[r] + logf(l[r]) : __int_as_float(0xff800000);
    }
}

static int launch(const void* q, const void* k, const void* v, void* out, const void* cur_len,
                  int B, int C, int S, int H, int Hkv, int dh, int k_off, float scale,
                  float soft_cap, void* stream) {
    if (dh < 16 || dh % 16 || dh > FA_MAXDH || H % Hkv) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)(2 * PB * (dh + 1) + PB * dh + PB * (PB + 1)) * sizeof(float);
    auto kernel = dh <= 128 ? chunk_partial<8> : chunk_partial<16>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((C + PB - 1) / PB, H, B);
    kernel<<<grid, PT, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out),
        static_cast<const long long*>(cur_len), C, S, H, Hkv, dh, k_off,
        scale, soft_cap);
    return (int)cudaGetLastError();
}

}  // namespace part

// The partial chunk entries: q [B, C, H, dh] at positions *cur_len + i against
// one slice k/v [B, S, Hkv, dh] holding positions offset .. offset + S - 1,
// causal, no window; out f32 [B, C, H, dh + 1] (context, then log-sum-exp).
extern "C" int flash_attention_chunk_partial_bf16(const void* q, const void* k, const void* v,
                                                  void* out, const void* cur_len, int B, int C,
                                                  int S, int H, int Hkv, int dh, int offset,
                                                  float scale, float soft_cap, void* stream) {
    return run_bf16(q, k, v, out, B, C, S, H, Hkv, dh, scale, 1, 0, soft_cap,
                    static_cast<const long long*>(cur_len), stream, offset, 1);
}

extern "C" int flash_attention_chunk_partial_f32(const void* q, const void* k, const void* v,
                                                 void* out, const void* cur_len, int B, int C,
                                                 int S, int H, int Hkv, int dh, int offset,
                                                 float scale, float soft_cap, void* stream) {
    return part::launch(q, k, v, out, cur_len, B, C, S, H, Hkv, dh, offset, scale, soft_cap,
                        stream);
}
