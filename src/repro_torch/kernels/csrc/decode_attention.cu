// Flash-decode: one query token per row against a contiguous KV cache, the
// g query heads of a KV head scored together, per-row valid lengths, an
// optional tanh soft-cap and an online softmax.
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py:_decode_kernel
// (pallas_call at decode_attention.py:108). q is [B, H, dh], the cache k/v
// [B, S, Hkv, dh] (the model's layout, read in place), lengths [B] the valid
// positions per row (cur_len + 1: the new token is written before scoring).
//
// Bound on this card: bytes (each valid K and V element is read once), but
// at decode the bytes are few (1.2 MB at 576 positions, 0.35 us at HBM
// rate), so what sets the time is latency: the launch, the first loads, the
// merge. The design keeps each of those to one:
//  * One launch, no workspace. On the TPU the KV axis was a sequential grid
//    dimension; here B * Hkv is small (4 at batch 1 for the paper's model),
//    so the S axis is cut into ``splits`` spans, one block each, and the
//    splits of one (b, KV head) form one thread block cluster (up to 16,
//    non-portable above 8). Each block runs the online softmax over its
//    span in tiles; then the cluster merges the (m, l, acc) partials in
//    split order, each block reading the others' through distributed shared
//    memory, and each writes a share of the outputs. Spans that start at or
//    past the row's length load nothing and are left out of the merge, so
//    the bytes read follow the valid length, not the cache capacity.
//  * The plan (splits, tile; ``kernels/decode_attention.py:decode_plan``)
//    comes from S, dh, g and the type only, never B or a row's length: a
//    row gives the same bits whatever the batch. The launcher only checks it.
//  * Loads in flight: K and V tiles move in 16-byte cp.async copies into a
//    2-stage shared ring; tile j+1's copies are issued before tile j is
//    scored, V_j lands while K_j is scored. Rows past the length are
//    zero-filled by the copy.
//  * bf16 at every dh that is a multiple of 16 up to 256: tensor cores,
//    mma.sync m16n8k16 with f32 sums.
//    Scores S^T = K Q^T take KV positions as M and the g query heads as N
//    (one n8 fragment for g <= 8, padded with zero rows of q; two for
//    g <= 16); the context O^T = V^T P^T takes dh as M and positions as K,
//    with P rounded to bf16 through shared memory (the Pallas body's f32
//    dot rounds its operands to bf16 on the TPU's matrix unit).
//    Where 4 warps do not divide the dh / 16 m-tiles of O^T (6 at dh 96, 10
//    at dh 160) the last warps skip the tiles past dh: a thread keeps MD x
//    NG x 4 floats of O (MD = 3 at dh 160, 4 at dh 256), and the ldmatrix
//    rows of dh + 8 bf16 stay 16-byte aligned and conflict-free at any
//    multiple of 16; shared memory is (16 + 4 TT) (dh + 8) + 16 (TT + 8)
//    bf16 and 16 dh f32 (65 KB at dh 96, 104 KB at dh 160, tile 64).
//  * f32, bf16 at other head dims, or unaligned tensors: a CUDA-core body
//    with the same spans, ring and merge (tf32 would round q and k, which
//    the reference keeps in f32).
// Positions at or past the length score NEG_INF before the max, as in
// _decode_kernel; the softmax runs in base 2 with log2(e) folded into the
// scores.
//
// The paged entry (decode_attention_paged_*) serves the serving engine's
// KV pool: k/v are planes [P, ps, Hkv, dh] shared by every row, and row b's
// logical position s lives at plane row page_table[b, s / ps] * ps + s % ps.
// It is the reference's gather (repro/models/attention.py:420-432) and
// scoring in one launch, with no [B, cap, Hkv, dh] copy: only the loader's
// address changes (``stage_rows`` finds each row's page, so a tile may
// cross page boundaries anywhere), never the plan, the scoring or the
// merge. So it is bitwise the contiguous entry on the gathered view and
// keeps its batch invariance.
//
// The partial entry (decode_attention_partial_*) scores one slice of a
// cache split by sequence over ranks (the cross-rank split-KV decode of a
// cache sharded by state_spec): the contiguous entry over the slice, with
// per-row local lengths that may be 0 (an empty slice: o 0, lse -inf, no
// NaN). It writes f32 rows [B, H, dh + 1]: the normalized context, then the
// natural-log sum of exponentials of the scores, M + log2(L) in base 2
// times ln 2 from the cluster merge's (M, L), one store a (row, head). The
// caller all-gathers those rows and merges the slices.
#include <cooperative_groups.h>

#include "common.cuh"

using namespace repro;
namespace cg = cooperative_groups;

constexpr int DA_THREADS = 128;
constexpr int DA_WARPS = DA_THREADS / 32;
constexpr int DA_MAXG = 16;          // query heads per KV head
constexpr int DA_MAXSPLITS = 16;     // the blocks of one (non-portable) cluster
constexpr int DA_PAD = 16;           // bytes of padding per shared row (ldmatrix without conflicts)
constexpr int DA_TC_MAXDH = 256;     // the tensor-core body's widest head (dh a multiple of 16)
constexpr float DA_LOG2E = 1.4426950408889634f;
constexpr float DA_LN2 = 0.6931471805599453f;

struct DecodeArgs {
    const void* q;
    const void* k;
    const void* v;
    const int32_t* lengths;
    const int32_t* page_table;   // [B, npages], or null: the contiguous cache
    void* out;
    int H, Hkv, S, dh, span;
    int npages, ps;              // the paged entry's table width and page size
    float scale;     // 1/sqrt(dh)
    float soft_cap;  // 0: none
    int partial;     // the partial entry: f32 out rows [B, H, dh + 1], the lse last
};

// Where row b's cache starts, and its page table: the contiguous cache
// [B, S, Hkv, dh], or (paged) the shared plane [P * ps, Hkv, dh], whose
// rows ``stage_rows`` finds through the table.
template <typename T>
__device__ __forceinline__ const T* cache_base(const DecodeArgs& a, const void* c, int b, int hk,
                                               const int32_t** pt) {
    if (a.page_table) {
        *pt = a.page_table + (size_t)b * a.npages;
        return static_cast<const T*>(c) + (size_t)hk * a.dh;
    }
    *pt = nullptr;
    return static_cast<const T*>(c) + ((size_t)b * a.S * a.Hkv + hk) * a.dh;
}

// The state a block leaves for the merge, in its shared memory: per head
// the running max (base 2) and sum, and the unnormalized context [16][dh].
struct Partial {
    float m[DA_MAXG];
    float l[DA_MAXG];
};

// The cluster's merge: every block reads the live splits' (m, l) and
// context rows through distributed shared memory and writes a share of the
// (b, KV head)'s g x dh outputs, summing in split order.
template <typename T>
__device__ void merge_splits(const DecodeArgs& a, const Partial& part, const float* Os, int live,
                             int b, int hk) {
    __shared__ float e[DA_MAXSPLITS][DA_MAXG];   // exp2(m_k - M) per split and head
    __shared__ float ml[2][DA_MAXSPLITS][DA_MAXG];
    __shared__ float inv[DA_MAXG];
    cg::cluster_group cluster = cg::this_cluster();
    const int g = a.H / a.Hkv, split = blockIdx.x, splits = gridDim.x, tid = threadIdx.x;
    cluster.sync();                                       // every block's partial is written
    for (int i = tid; i < live * DA_MAXG; i += DA_THREADS) {
        const int k = i / DA_MAXG, h = i % DA_MAXG;
        const Partial* pk = cluster.map_shared_rank(&part, k);
        ml[0][k][h] = pk->m[h];
        ml[1][k][h] = pk->l[h];
    }
    __syncthreads();
    if (tid < g) {
        float M = NEG_INF, L = 0.f;
        for (int k = 0; k < live; ++k) M = fmaxf(M, ml[0][k][tid]);
        for (int k = 0; k < live; ++k) {
            const float ek = exp2f(ml[0][k][tid] - M);
            e[k][tid] = ek;
            L += ek * ml[1][k][tid];
        }
        inv[tid] = 1.f / fmaxf(L, 1e-30f);
        if (a.partial && split == 0)                      // lse = ln(2^M L); -inf when empty
            static_cast<float*>(a.out)[((size_t)b * a.H + (size_t)hk * g + tid) * (a.dh + 1)
                                       + a.dh] =
                L > 0.f ? (M + log2f(L)) * DA_LN2 : __int_as_float(0xff800000);
    }
    __syncthreads();
    const int dh = a.dh;
    T* out = static_cast<T*>(a.out) + ((size_t)b * a.H + (size_t)hk * g) * dh;
    float* pout = static_cast<float*>(a.out) + ((size_t)b * a.H + (size_t)hk * g) * (dh + 1);
    for (int i = split * DA_THREADS + tid; i < g * dh; i += DA_THREADS * splits) {
        const int h = i / dh;
        float o = 0.f;
#pragma unroll 4
        for (int k = 0; k < live; ++k) o += e[k][h] * cluster.map_shared_rank(Os, k)[i];
        if (a.partial)
            pout[h * (dh + 1) + i % dh] = o * inv[h];
        else
            out[i] = from_f<T>(o * inv[h]);
    }
    cluster.sync();                                       // keep the partials alive for the readers
}

// The row of a [*, ld] matrix that logical row r lives in: r itself, or
// through a page table of ``ps``-row pages
__device__ __forceinline__ size_t phys_row(int r, const int32_t* pt, int ps) {
    return pt ? (size_t)pt[r / ps] * ps + r % ps : (size_t)r;
}

// rows [r0, r0 + rows) of a [*, ld] matrix of T (logical rows, mapped by
// ``pt`` when it is not null) into a shared tile with row stride ``lds``
// elements: 16-byte copies (``vec``: rows of whole 16-byte chunks, 16-byte
// aligned) or element loads; rows at or past ``end`` read as zeros
template <typename T>
__device__ __forceinline__ void stage_rows(T* s, int lds, const T* g, size_t ld, int r0, int rows,
                                           int end, int width, bool vec,
                                           const int32_t* pt = nullptr, int ps = 1) {
    if (vec) {
        constexpr int E = 16 / sizeof(T);
        const int ch = width / E;
        for (int i = threadIdx.x; i < rows * ch; i += DA_THREADS) {
            const int r = i / ch, c = i % ch;
            const bool ok = r0 + r < end;
            cp_async16(s + r * lds + c * E, g + (ok ? phys_row(r0 + r, pt, ps) : 0) * ld + c * E,
                       ok);
        }
    } else {
        for (int i = threadIdx.x; i < rows * width; i += DA_THREADS) {
            const int r = i / width, c = i % width;
            s[r * lds + c] = r0 + r < end ? g[phys_row(r0 + r, pt, ps) * ld + c] : from_f<T>(0.f);
        }
    }
}

// ---------------------------------------------------------------------------
// bf16 on tensor cores: block (split, b * Hkv + hk), 4 warps, tiles of TT
// positions; NG n8 fragments of query heads
// ---------------------------------------------------------------------------
template <int DH, int TT, int NG>
__global__ void __launch_bounds__(DA_THREADS)
decode_tc(DecodeArgs a) {
    using bf16 = __nv_bfloat16;
    constexpr int LDS = DH + DA_PAD / 2, LDP = TT + DA_PAD / 2, KD = DH / 16;
    constexpr int MT = (TT / 16 + DA_WARPS - 1) / DA_WARPS;    // position m-tiles per warp
    constexpr int MD = (DH / 16 + DA_WARPS - 1) / DA_WARPS;    // dh m-tiles per warp
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);             // [16][LDS], rows >= g zero
    bf16* Ks = Qs + 16 * LDS;                                   // [2][TT][LDS]
    bf16* Vs = Ks + 2 * TT * LDS;                               // [2][TT][LDS]
    bf16* Ps = Vs + 2 * TT * LDS;                               // [16][LDP] probabilities
    float* Os = reinterpret_cast<float*>(Ps + 16 * LDP);        // [16][DH] context
    __shared__ Partial part;
    __shared__ float redm[DA_WARPS][DA_MAXG], reds[DA_WARPS][DA_MAXG];

    const int g = a.H / a.Hkv, b = blockIdx.y / a.Hkv, hk = blockIdx.y % a.Hkv;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gq = lane >> 2, t4 = lane & 3;
    const int len = min(a.lengths[b], a.S);
    const int start = blockIdx.x * a.span, end = min(start + a.span, len);
    const int ntiles = end > start ? (end - start + TT - 1) / TT : 0;
    const int live = min((int)gridDim.x, (len + a.span - 1) / a.span);
    const size_t ldk = (size_t)a.Hkv * DH;
    const int32_t* pt;
    const bf16* kg = cache_base<bf16>(a, a.k, b, hk, &pt);
    const bf16* vg = cache_base<bf16>(a, a.v, b, hk, &pt);
    const bf16* qg = static_cast<const bf16*>(a.q) + ((size_t)b * a.H + (size_t)hk * g) * DH;

    if (tid < DA_MAXG) {
        part.m[tid] = NEG_INF;
        part.l[tid] = 0.f;
    }
    float o[MD][NG][4];
#pragma unroll
    for (int i = 0; i < MD; ++i)
#pragma unroll
        for (int n = 0; n < NG; ++n) o[i][n][0] = o[i][n][1] = o[i][n][2] = o[i][n][3] = 0.f;

    // commit groups in order: Q + K_0, V_0, K_1, V_1, ...
    if (ntiles > 0) {
        stage_rows(Qs, LDS, qg, DH, 0, 16, g, DH, true);
        stage_rows(Ks, LDS, kg, ldk, start, TT, end, DH, true, pt, a.ps);
    }
    cp_async_commit();
    if (ntiles > 0) stage_rows(Vs, LDS, vg, ldk, start, TT, end, DH, true, pt, a.ps);
    cp_async_commit();

    uint32_t qb[KD][4];
    for (int j = 0; j < ntiles; ++j) {
        const int k0 = start + j * TT, st = (j + 1) & 1;
        if (j + 1 < ntiles)
            stage_rows(Ks + st * TT * LDS, LDS, kg, ldk, k0 + TT, TT, end, DH, true, pt, a.ps);
        cp_async_commit();
        if (j + 1 < ntiles)
            stage_rows(Vs + st * TT * LDS, LDS, vg, ldk, k0 + TT, TT, end, DH, true, pt, a.ps);
        cp_async_commit();
        cp_async_wait<3>();                                     // K_j (and Q) have landed
        __syncthreads();
        if (j == 0) {
#pragma unroll
            for (int kk = 0; kk < KD; ++kk)
                ldmatrix_x4(qb[kk], Qs + ((lane & 7) + ((lane >> 4) << 3)) * LDS + kk * 16
                                        + ((lane >> 3) & 1) * 8);
        }
        const bf16* Kt = Ks + (j & 1) * TT * LDS;
        const bf16* Vt = Vs + (j & 1) * TT * LDS;

        // S^T = K Q^T: the warp's position m-tiles against the heads
        float s[MT][NG][4];
        float mx[NG][2];
#pragma unroll
        for (int n = 0; n < NG; ++n) mx[n][0] = mx[n][1] = NEG_INF;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
            const int mt = warp + i * DA_WARPS;
#pragma unroll
            for (int n = 0; n < NG; ++n) s[i][n][0] = s[i][n][1] = s[i][n][2] = s[i][n][3] = 0.f;
            if (mt * 16 >= TT) continue;
#pragma unroll
            for (int kk = 0; kk < KD; ++kk) {
                uint32_t ka[4];
                ldmatrix_x4(ka, Kt + (mt * 16 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
                for (int n = 0; n < NG; ++n) mma(s[i][n], ka, qb[kk][2 * n], qb[kk][2 * n + 1]);
            }
            // scale, soft-cap, mask; c0/c1 are position gq, c2/c3 gq + 8
#pragma unroll
            for (int n = 0; n < NG; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    float x = s[i][n][e] * a.scale;
                    if (a.soft_cap > 0.f) x = a.soft_cap * tanhf(x / a.soft_cap);
                    x *= DA_LOG2E;
                    if (k0 + mt * 16 + gq + (e >> 1) * 8 >= end) x = NEG_INF;
                    s[i][n][e] = x;
                    mx[n][e & 1] = fmaxf(mx[n][e & 1], x);
                }
            }
        }
        // the warp's max per head (over the 8 lanes of a column), then the block's
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
#pragma unroll
                for (int off = 4; off < 32; off <<= 1)
                    mx[n][c] = fmaxf(mx[n][c], __shfl_xor_sync(0xffffffffu, mx[n][c], off));
                if (gq == 0) redm[warp][n * 8 + 2 * t4 + c] = mx[n][c];
            }
        __syncthreads();
        float m_new[NG][2], corr[NG][2], sum[NG][2];
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                const int h = n * 8 + 2 * t4 + c;
                float t = redm[0][h];
#pragma unroll
                for (int w = 1; w < DA_WARPS; ++w) t = fmaxf(t, redm[w][h]);
                m_new[n][c] = fmaxf(part.m[h], t);
                corr[n][c] = exp2f(part.m[h] - m_new[n][c]);
                sum[n][c] = 0.f;
            }
        // P = exp2(s - m), rounded to bf16 into Ps [head][position]
#pragma unroll
        for (int i = 0; i < MT; ++i) {
            const int mt = warp + i * DA_WARPS;
            if (mt * 16 >= TT) continue;
#pragma unroll
            for (int n = 0; n < NG; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int c = e & 1;
                    const float p = s[i][n][e] > NEG_INF ? exp2f(s[i][n][e] - m_new[n][c]) : 0.f;
                    sum[n][c] += p;
                    Ps[(n * 8 + 2 * t4 + c) * LDP + mt * 16 + gq + (e >> 1) * 8] =
                        __float2bfloat16_rn(p);
                }
        }
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
#pragma unroll
                for (int off = 4; off < 32; off <<= 1)
                    sum[n][c] += __shfl_xor_sync(0xffffffffu, sum[n][c], off);
                if (gq == 0) reds[warp][n * 8 + 2 * t4 + c] = sum[n][c];
            }
        // rescale the context: columns of o are heads 2 * t4 + {0, 1} (+ 8 n)
#pragma unroll
        for (int i = 0; i < MD; ++i)
#pragma unroll
            for (int n = 0; n < NG; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) o[i][n][e] *= corr[n][e & 1];
        cp_async_wait<2>();                                     // V_j has landed
        __syncthreads();                                        // Ps, reds, V_j visible
        if (tid < DA_MAXG) {                                    // the running max and sum
            float t = redm[0][tid], l = 0.f;
#pragma unroll
            for (int w = 1; w < DA_WARPS; ++w) t = fmaxf(t, redm[w][tid]);
#pragma unroll
            for (int w = 0; w < DA_WARPS; ++w) l += reds[w][tid];
            const float mn = fmaxf(part.m[tid], t);
            part.l[tid] = part.l[tid] * exp2f(part.m[tid] - mn) + l;
            part.m[tid] = mn;
        }
        // O^T += V^T P^T: the warp's dh m-tiles over the tile's positions
#pragma unroll
        for (int kk = 0; kk < TT / 16; ++kk) {
            uint32_t pb[4];
            ldmatrix_x4(pb, Ps + ((lane & 7) + ((lane >> 4) << 3)) * LDP + kk * 16
                                + ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int i = 0; i < MD; ++i) {
                const int md = warp + i * DA_WARPS;
                if (md * 16 >= DH) continue;
                uint32_t va[4];
                ldmatrix_x4_trans(va, Vt + (kk * 16 + (lane & 7) + (lane >> 4) * 8) * LDS
                                          + md * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
                for (int n = 0; n < NG; ++n) mma(o[i][n], va, pb[2 * n], pb[2 * n + 1]);
            }
        }
        __syncthreads();                                        // stage j & 1, Ps free again
    }
    cp_async_wait<0>();
    // the context into Os [head][dh]: rows of o are dh gq (+ 8), columns heads
#pragma unroll
    for (int i = 0; i < MD; ++i) {
        const int md = warp + i * DA_WARPS;
        if (md * 16 >= DH) continue;
#pragma unroll
        for (int n = 0; n < NG; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                Os[(n * 8 + 2 * t4 + (e & 1)) * DH + md * 16 + gq + (e >> 1) * 8] = o[i][n][e];
    }
    merge_splits<bf16>(a, part, Os, live, b, hk);
}

// ---------------------------------------------------------------------------
// CUDA cores, any type and head dim: the same spans, ring and merge; the
// context accumulates in shared memory, one (head, d) entry per thread
// ---------------------------------------------------------------------------
template <typename T, int TT>
__global__ void __launch_bounds__(DA_THREADS)
decode_cc(DecodeArgs a, int vec) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int g = a.H / a.Hkv, dh = a.dh;
    const int lds = dh + DA_PAD / (int)sizeof(T);
    float* Qf = reinterpret_cast<float*>(smem_raw);            // [g][dh]
    float* Sc = Qf + g * dh;                                    // [g][TT] scores, then probs
    float* Os = Sc + g * TT;                                    // [g][dh] context
    T* Ks = reinterpret_cast<T*>(Os + g * dh);                  // [2][TT][lds]
    T* Vs = Ks + 2 * TT * lds;                                  // [2][TT][lds]
    __shared__ Partial part;
    __shared__ float corr[DA_MAXG];

    const int b = blockIdx.y / a.Hkv, hk = blockIdx.y % a.Hkv;
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int len = min(a.lengths[b], a.S);
    const int start = blockIdx.x * a.span, end = min(start + a.span, len);
    const int ntiles = end > start ? (end - start + TT - 1) / TT : 0;
    const int live = min((int)gridDim.x, (len + a.span - 1) / a.span);
    const size_t ldk = (size_t)a.Hkv * dh;
    const int32_t* pt;
    const T* kg = cache_base<T>(a, a.k, b, hk, &pt);
    const T* vg = cache_base<T>(a, a.v, b, hk, &pt);
    const T* qg = static_cast<const T*>(a.q) + ((size_t)b * a.H + (size_t)hk * g) * dh;

    if (tid < DA_MAXG) {
        part.m[tid] = NEG_INF;
        part.l[tid] = 0.f;
    }
    for (int i = tid; i < g * dh; i += DA_THREADS) {
        Qf[i] = to_f(qg[i]);
        Os[i] = 0.f;
    }
    if (ntiles > 0) stage_rows(Ks, lds, kg, ldk, start, TT, end, dh, vec, pt, a.ps);
    cp_async_commit();
    if (ntiles > 0) stage_rows(Vs, lds, vg, ldk, start, TT, end, dh, vec, pt, a.ps);
    cp_async_commit();
    for (int j = 0; j < ntiles; ++j) {
        const int k0 = start + j * TT, st = (j + 1) & 1, n = min(TT, end - k0);
        if (j + 1 < ntiles)
            stage_rows(Ks + st * TT * lds, lds, kg, ldk, k0 + TT, TT, end, dh, vec, pt, a.ps);
        cp_async_commit();
        if (j + 1 < ntiles)
            stage_rows(Vs + st * TT * lds, lds, vg, ldk, k0 + TT, TT, end, dh, vec, pt, a.ps);
        cp_async_commit();
        cp_async_wait<3>();                                     // K_j has landed
        __syncthreads();
        const T* Kt = Ks + (j & 1) * TT * lds;
        const T* Vt = Vs + (j & 1) * TT * lds;
        for (int i = tid; i < g * TT; i += DA_THREADS) {        // neighbouring lanes, neighbouring rows
            const int h = i / TT, p = i % TT;
            float x = NEG_INF;
            if (p < n) {
                float acc = 0.f;
                for (int d = 0; d < dh; ++d) acc += Qf[h * dh + d] * to_f(Kt[p * lds + d]);
                x = acc * a.scale;
                if (a.soft_cap > 0.f) x = a.soft_cap * tanhf(x / a.soft_cap);
                x *= DA_LOG2E;
            }
            Sc[i] = x;
        }
        __syncthreads();
        for (int h = warp; h < g; h += DA_WARPS) {              // a warp per head
            float t = NEG_INF;
            for (int p = lane; p < TT; p += 32) t = fmaxf(t, Sc[h * TT + p]);
            t = warp_max(t);
            const float mn = fmaxf(part.m[h], t);
            float l = 0.f;
            for (int p = lane; p < TT; p += 32) {
                const float x = Sc[h * TT + p];
                const float pr = x > NEG_INF ? exp2f(x - mn) : 0.f;
                Sc[h * TT + p] = pr;
                l += pr;
            }
            l = warp_sum(l);
            if (lane == 0) {
                const float c = exp2f(part.m[h] - mn);
                corr[h] = c;
                part.l[h] = part.l[h] * c + l;
                part.m[h] = mn;
            }
        }
        cp_async_wait<2>();                                     // V_j has landed
        __syncthreads();
        for (int i = tid; i < g * dh; i += DA_THREADS) {
            const int h = i / dh, d = i % dh;
            float acc = Os[i] * corr[h];
            for (int p = 0; p < n; ++p) acc += Sc[h * TT + p] * to_f(Vt[p * lds + d]);
            Os[i] = acc;
        }
        __syncthreads();                                        // stage j & 1, Sc free again
    }
    cp_async_wait<0>();
    merge_splits<T>(a, part, Os, live, b, hk);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
template <typename... P, typename... A>
static int launch_cluster(void (*kernel)(P...), int B, int Hkv, int splits, size_t smem,
                          cudaStream_t st, A... args) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err == cudaSuccess && splits > 8)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(splits, B * Hkv);
    cfg.blockDim = dim3(DA_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute cluster[1];
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = splits;                      // the splits of one (b, KV head)
    cluster[0].val.clusterDim.y = 1;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

template <int DH, int TT>
static int launch_tc(const DecodeArgs& a, int B, int splits, cudaStream_t st) {
    const int g = a.H / a.Hkv;
    constexpr int LDS = DH + DA_PAD / 2, LDP = TT + DA_PAD / 2;
    const size_t smem = (size_t)(16 * LDS + 4 * TT * LDS + 16 * LDP) * 2 + 16 * DH * 4;
    if (g <= 8) return launch_cluster(decode_tc<DH, TT, 1>, B, a.Hkv, splits, smem, st, a);
    return launch_cluster(decode_tc<DH, TT, 2>, B, a.Hkv, splits, smem, st, a);
}

template <typename T, int TT>
static int launch_cc(const DecodeArgs& a, int B, int splits, int vec, cudaStream_t st) {
    const int g = a.H / a.Hkv, lds = a.dh + DA_PAD / (int)sizeof(T);
    const size_t smem = (size_t)(2 * g * a.dh + g * TT) * 4 + (size_t)4 * TT * lds * sizeof(T);
    return launch_cluster(decode_cc<T, TT>, B, a.Hkv, splits, smem, st, a, vec);
}

// The plan's checks: ``splits`` spans of ``span`` positions (a multiple of
// the tile) cover S, none of them wholly past it, in one cluster; the
// tensor-core body takes bf16 at every dh that is a multiple of 16 up to 256
// (DA_TC_MAXDH), with whole 16-byte rows.
static bool plan_ok(int B, int H, int Hkv, int S, int dh, int splits, int tile, int span,
                    int tensor_cores, int vec, int elem) {
    if (B < 1 || Hkv < 1 || H % Hkv || H / Hkv > DA_MAXG || S < 1 || dh < 1) return false;
    if (splits < 1 || splits > DA_MAXSPLITS || (tile != 32 && tile != 64) || span < tile
        || span % tile || (long)splits * span < S || (long)(splits - 1) * span >= S)
        return false;
    if (vec && (dh * elem) % 16) return false;
    if (tensor_cores && (elem != 2 || !vec || dh % 16 || dh > DA_TC_MAXDH)) return false;
    return true;
}

// ``page_table`` null: the contiguous cache of S positions; else the paged
// planes, each row's table ``npages`` pages of ``ps`` (S = npages * ps).
template <typename T>
static int launch_decode(const void* q, const void* k, const void* v, const void* lengths,
                         const void* page_table, int npages, int ps,
                         int B, int H, int Hkv, int S, int dh, float scale, float soft_cap,
                         int splits, int tile, int span, int tensor_cores, int vec, void* out,
                         void* stream, int partial = 0) {
    if (!plan_ok(B, H, Hkv, S, dh, splits, tile, span, tensor_cores, vec, (int)sizeof(T)))
        return (int)cudaErrorInvalidValue;
    if (page_table && (npages < 1 || ps < 1 || (long)npages * ps != S))
        return (int)cudaErrorInvalidValue;
    const DecodeArgs a{q, k, v, static_cast<const int32_t*>(lengths),
                       static_cast<const int32_t*>(page_table), out,
                       H, Hkv, S, dh, span, npages, ps, scale, soft_cap, partial};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if constexpr (sizeof(T) == 2) {
        if (tensor_cores) {
#define DA_TC_CASE(D)                                                              \
    case D: return tile == 64 ? launch_tc<D, 64>(a, B, splits, st)                 \
                              : launch_tc<D, 32>(a, B, splits, st);
            switch (dh) {
                DA_TC_CASE(16) DA_TC_CASE(32) DA_TC_CASE(48) DA_TC_CASE(64)
                DA_TC_CASE(80) DA_TC_CASE(96) DA_TC_CASE(112) DA_TC_CASE(128)
                DA_TC_CASE(144) DA_TC_CASE(160) DA_TC_CASE(176) DA_TC_CASE(192)
                DA_TC_CASE(208) DA_TC_CASE(224) DA_TC_CASE(240) DA_TC_CASE(256)
                default: return (int)cudaErrorInvalidValue;
            }
#undef DA_TC_CASE
        }
    }
    return tile == 64 ? launch_cc<T, 64>(a, B, splits, vec, st)
                      : launch_cc<T, 32>(a, B, splits, vec, st);
}

// One entry per type; the plan (splits, tile, span, body, vector copies) is
// the wrapper's (kernels/decode_attention.py:decode_plan).
extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* lengths, int B, int H, int Hkv, int S, int dh,
                                     float scale, float soft_cap, int splits, int tile, int span,
                                     int tensor_cores, int vec, void* out, void* stream) {
    return launch_decode<__nv_bfloat16>(q, k, v, lengths, nullptr, 0, 0, B, H, Hkv, S, dh, scale,
                                        soft_cap, splits, tile, span, tensor_cores, vec, out,
                                        stream);
}

extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    const void* lengths, int B, int H, int Hkv, int S, int dh,
                                    float scale, float soft_cap, int splits, int tile, int span,
                                    int tensor_cores, int vec, void* out, void* stream) {
    return launch_decode<float>(q, k, v, lengths, nullptr, 0, 0, B, H, Hkv, S, dh, scale,
                                soft_cap, splits, tile, span, tensor_cores, vec, out, stream);
}

// The paged entry: k/v the shared planes [P, ps, Hkv, dh], page_table
// [B, npages] int32; the plan is the contiguous entry's at S = npages * ps.
extern "C" int decode_attention_paged_bf16(const void* q, const void* k, const void* v,
                                           const void* lengths, const void* page_table, int B,
                                           int H, int Hkv, int npages, int ps, int dh, float scale,
                                           float soft_cap, int splits, int tile, int span,
                                           int tensor_cores, int vec, void* out, void* stream) {
    return launch_decode<__nv_bfloat16>(q, k, v, lengths, page_table, npages, ps, B, H, Hkv,
                                        npages * ps, dh, scale, soft_cap, splits, tile, span,
                                        tensor_cores, vec, out, stream);
}

extern "C" int decode_attention_paged_f32(const void* q, const void* k, const void* v,
                                          const void* lengths, const void* page_table, int B,
                                          int H, int Hkv, int npages, int ps, int dh, float scale,
                                          float soft_cap, int splits, int tile, int span,
                                          int tensor_cores, int vec, void* out, void* stream) {
    return launch_decode<float>(q, k, v, lengths, page_table, npages, ps, B, H, Hkv, npages * ps,
                                dh, scale, soft_cap, splits, tile, span, tensor_cores, vec, out,
                                stream);
}

// The partial entry: the contiguous entry over one slice of a cache split by
// sequence, ``lengths`` the slice's per-row local lengths (0 allowed), out
// f32 [B, H, dh + 1]: the normalized context and the lse of each head.
extern "C" int decode_attention_partial_bf16(const void* q, const void* k, const void* v,
                                             const void* lengths, int B, int H, int Hkv, int S,
                                             int dh, float scale, float soft_cap, int splits,
                                             int tile, int span, int tensor_cores, int vec,
                                             void* out, void* stream) {
    return launch_decode<__nv_bfloat16>(q, k, v, lengths, nullptr, 0, 0, B, H, Hkv, S, dh, scale,
                                        soft_cap, splits, tile, span, tensor_cores, vec, out,
                                        stream, 1);
}

extern "C" int decode_attention_partial_f32(const void* q, const void* k, const void* v,
                                            const void* lengths, int B, int H, int Hkv, int S,
                                            int dh, float scale, float soft_cap, int splits,
                                            int tile, int span, int tensor_cores, int vec,
                                            void* out, void* stream) {
    return launch_decode<float>(q, k, v, lengths, nullptr, 0, 0, B, H, Hkv, S, dh, scale,
                                soft_cap, splits, tile, span, tensor_cores, vec, out, stream, 1);
}
