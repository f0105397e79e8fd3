// The port's host-side graph and plan builder (C++/OpenMP), a copy of the
// JAX package's native library with the same plain C entry points.
//
// Linear-time (counting-sort based, OpenMP-parallel) construction of the CSR
// and CSC orders and of the v1, v2 and v3 plans' arrays, the 128x128 block
// counts of the v3 and v5 plans, and an R-MAT edge generator.  It computes
// on host arrays, before anything reaches the card.  Every array it builds
// equals the numpy build's (isplib_tpu_torch/sparse/), which stays the
// reference.
//
// Plain C ABI, bound with ctypes (isplib_tpu_torch/native/__init__.py).  All
// buffers are caller-allocated; the two-phase count/fill pattern avoids
// ownership transfer across the FFI.  Built at first use by
// isplib_tpu_torch/native/build.py.

#include <cstdint>
#include <cstring>
#include <atomic>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// CSR construction: stable counting sort of COO edges by (row, col).
//
// out_order[e] = index into the input arrays of the e-th edge in CSR order.
// out_rowptr has num_rows+1 entries.
// ---------------------------------------------------------------------------
void isplib_sort_csr(const int32_t* row, const int32_t* col, int64_t nnz,
                     int32_t num_rows, int32_t num_cols,
                     int32_t* out_order, int64_t* out_rowptr,
                     int32_t* scratch /* nnz int32 */) {
    // pass 1: stable counting sort by col -> scratch holds the permutation
    {
        int64_t* cnt = new int64_t[(int64_t)num_cols + 1]();
        for (int64_t e = 0; e < nnz; ++e) cnt[col[e] + 1]++;
        for (int64_t c = 0; c < num_cols; ++c) cnt[c + 1] += cnt[c];
        for (int64_t e = 0; e < nnz; ++e) scratch[cnt[col[e]]++] = (int32_t)e;
        delete[] cnt;
    }
    // pass 2: stable counting sort by row over the col-sorted order
    {
        int64_t* cnt = new int64_t[(int64_t)num_rows + 1]();
        for (int64_t e = 0; e < nnz; ++e) cnt[row[e] + 1]++;
        for (int64_t r = 0; r < num_rows; ++r) cnt[r + 1] += cnt[r];
        std::memcpy(out_rowptr, cnt, sizeof(int64_t) * ((int64_t)num_rows + 1));
        for (int64_t e = 0; e < nnz; ++e) {
            int32_t src = scratch[e];
            out_order[cnt[row[src]]++] = src;
        }
        delete[] cnt;
    }
}

// ---------------------------------------------------------------------------
// Tiling plan (phase 1): count chunks.
//
// Input edges must already be CSR-sorted (row-major).  Buckets are
// (row/rb, col/ct) pairs; each bucket's edges split into ceil(n/eb) chunks;
// row blocks with zero edges get one chunk.  Returns total chunk count.
// bucket_of[e] (scratch, nnz) receives each edge's dense chunk id in the
// final (row-block-major, col-tile, row) order, and edge_rank[e] its slot.
// ---------------------------------------------------------------------------
int64_t isplib_plan_count(const int32_t* row, const int32_t* col,
                          int64_t nnz, int32_t num_rows, int32_t num_cols,
                          int32_t rb, int32_t ct, int32_t eb,
                          int64_t* chunk_of /* nnz */,
                          int64_t* rank_in_chunk /* nnz */,
                          int64_t* chunk_starts /* nrb+1 */) {
    const int64_t nrb = (num_rows + rb - 1) / rb;
    const int64_t nct = (num_cols + ct - 1) / ct;

    int64_t total_chunks = 0;
    // Per row block: counting sort of its edges by col tile (stable ->
    // preserves row order within tile), then chunking.  Row blocks are
    // independent -> OpenMP.  First find row-block edge ranges via rowptr
    // semantics reconstructed by scanning (input is row-sorted).
    int64_t* blk_start = new int64_t[nrb + 1];
    {
        // edges sorted by row -> block boundaries by binary search per block
        blk_start[0] = 0;
        int64_t e = 0;
        for (int64_t b = 1; b <= nrb; ++b) {
            int32_t bound = (int64_t)b * rb < num_rows ? (int32_t)(b * rb)
                                                       : num_rows;
            while (e < nnz && row[e] < bound) ++e;
            blk_start[b] = e;
        }
    }

    int64_t* blk_chunks = new int64_t[nrb];
#pragma omp parallel for schedule(dynamic, 1)
    for (int64_t b = 0; b < nrb; ++b) {
        const int64_t lo = blk_start[b], hi = blk_start[b + 1];
        const int64_t n = hi - lo;
        if (n == 0) { blk_chunks[b] = 1; continue; }  // empty: 1 pad chunk
        // count per-col-tile
        int64_t* cnt = new int64_t[nct + 1]();
        for (int64_t e = lo; e < hi; ++e) cnt[col[e] / ct + 1]++;
        // chunks per tile; prefix for local chunk ids
        int64_t chunks_here = 0;
        int64_t* tile_chunk_base = new int64_t[nct];
        for (int64_t t = 0; t < nct; ++t) {
            tile_chunk_base[t] = chunks_here;
            chunks_here += (cnt[t + 1] + eb - 1) / eb;
        }
        // prefix of counts for stable positioning within the block
        for (int64_t t = 0; t < nct; ++t) cnt[t + 1] += cnt[t];
        // assign each edge its (local chunk, slot)
        int64_t* cursor = new int64_t[nct]();
        for (int64_t e = lo; e < hi; ++e) {
            const int64_t t = col[e] / ct;
            const int64_t pos = cursor[t]++;     // rank within tile (row order)
            chunk_of[e] = tile_chunk_base[t] + pos / eb;  // block-local id
            rank_in_chunk[e] = pos % eb;
        }
        blk_chunks[b] = chunks_here;
        delete[] cnt; delete[] tile_chunk_base; delete[] cursor;
    }
    chunk_starts[0] = 0;
    for (int64_t b = 0; b < nrb; ++b)
        chunk_starts[b + 1] = chunk_starts[b] + blk_chunks[b];
    total_chunks = chunk_starts[nrb];
    // globalize block-local chunk ids
#pragma omp parallel for schedule(dynamic, 1)
    for (int64_t b = 0; b < nrb; ++b) {
        const int64_t lo = blk_start[b], hi = blk_start[b + 1];
        const int64_t base = chunk_starts[b];
        for (int64_t e = lo; e < hi; ++e) chunk_of[e] += base;
    }
    delete[] blk_start;
    delete[] blk_chunks;
    return total_chunks;
}

// ---------------------------------------------------------------------------
// Tiling plan (phase 2): fill the packed chunk arrays.
//
// edges_packed layout: (nc, 3, eb) int32 — plane 0 local rows, plane 1
// local cols, plane 2 float32 values bit-cast.  Caller zero-fills
// beforehand (pad slots must be 0 = inert value).
// ---------------------------------------------------------------------------
// rb_ids are NOT filled here: every chunk in block b's chunk_starts range
// has rb_id == b by construction, so Python derives them as
// np.repeat(arange(nrb), diff(chunk_starts)).
void isplib_plan_fill(const int32_t* row, const int32_t* col,
                      const float* val, int64_t nnz,
                      int32_t rb, int32_t ct, int32_t eb,
                      const int64_t* chunk_of, const int64_t* rank_in_chunk,
                      int64_t nc,
                      int32_t* edges_packed /* nc*3*eb, pre-zeroed */,
                      int32_t* ct_ids /* nc, pre-zeroed */) {
#pragma omp parallel for schedule(static)
    for (int64_t e = 0; e < nnz; ++e) {
        const int64_t c = chunk_of[e];
        const int64_t s = rank_in_chunk[e];
        int32_t* chunk = edges_packed + c * 3 * (int64_t)eb;
        const int32_t rbid = row[e] / rb;
        const int32_t ctid = col[e] / ct;
        chunk[s] = row[e] - rbid * rb;
        chunk[eb + s] = col[e] - ctid * ct;
        std::memcpy(chunk + 2 * (int64_t)eb + s, &val[e], 4);
        if (s == 0) ct_ids[c] = ctid;
    }
}

// ---------------------------------------------------------------------------
// v2 tiling plan: column-major streaming order (superblock, ct, rb, row).
//
// Counterpart of sparse/tiling_v2.py's numpy builder.  Input edges must be
// CSR-sorted.  Phase 1 assigns each edge a global chunk id + slot and fills
// cell_starts (n_super*nct + 1) and per-chunk rb_locals; returns nc.
// Buckets are (super, ct, rb); chunks = ceil(n/eb) per non-empty bucket
// (no pad chunks — the kernel zero-fills every output block).
// ---------------------------------------------------------------------------
int64_t isplib_plan_v2_count(const int32_t* row, const int32_t* col,
                             int64_t nnz, int32_t num_rows, int32_t num_cols,
                             int32_t rb, int32_t ct, int32_t eb,
                             int32_t nrb_s,
                             int64_t* chunk_of /* nnz */,
                             int64_t* rank_in_chunk /* nnz */,
                             int64_t* cell_starts /* n_super*nct+1 */,
                             int64_t rbl_cap, int32_t* rb_locals /* cap */) {
    const int64_t nrb = (num_rows + rb - 1) / rb;
    const int64_t nct = (num_cols + ct - 1) / ct;
    const int64_t n_super = (nrb + nrb_s - 1) / nrb_s;
    const int64_t sb_rows = (int64_t)nrb_s * rb;

    // super boundaries by scanning the row-sorted edges
    int64_t* sup_start = new int64_t[n_super + 1];
    sup_start[0] = 0;
    {
        int64_t e = 0;
        for (int64_t s = 1; s <= n_super; ++s) {
            int64_t bound = s * sb_rows;
            if (bound > num_rows) bound = num_rows;
            while (e < nnz && row[e] < bound) ++e;
            sup_start[s] = e;
        }
    }

    // phase A (parallel over supers): per-super bucket counts -> local
    // chunk ids; chunks ordered (ct, rb) within the super.
    int64_t* sup_chunks = new int64_t[n_super]();
    // per-super, per-cell chunk counts for cell_starts
    int64_t* cell_cnt = new int64_t[n_super * nct]();
#pragma omp parallel for schedule(dynamic, 1)
    for (int64_t s = 0; s < n_super; ++s) {
        const int64_t lo = sup_start[s], hi = sup_start[s + 1];
        if (lo == hi) continue;
        const int64_t nb = nct * nrb_s;           // buckets in this super
        int64_t* cnt = new int64_t[nb]();
        for (int64_t e = lo; e < hi; ++e) {
            const int64_t t = col[e] / ct;
            const int64_t rbl = row[e] / rb - s * nrb_s;
            cnt[t * nrb_s + rbl]++;
        }
        int64_t chunks_here = 0;
        int64_t* base = new int64_t[nb];
        for (int64_t t = 0; t < nct; ++t) {
            int64_t cell_chunks = 0;
            for (int64_t r = 0; r < nrb_s; ++r) {
                const int64_t b = t * nrb_s + r;
                base[b] = chunks_here;
                const int64_t ch = (cnt[b] + eb - 1) / eb;
                chunks_here += ch;
                cell_chunks += ch;
            }
            cell_cnt[s * nct + t] = cell_chunks;
        }
        int64_t* cursor = new int64_t[nb]();
        for (int64_t e = lo; e < hi; ++e) {
            const int64_t t = col[e] / ct;
            const int64_t rbl = row[e] / rb - s * nrb_s;
            const int64_t b = t * nrb_s + rbl;
            const int64_t pos = cursor[b]++;
            chunk_of[e] = base[b] + pos / eb;     // super-local id
            rank_in_chunk[e] = pos % eb;
        }
        sup_chunks[s] = chunks_here;
        delete[] cnt; delete[] base; delete[] cursor;
    }

    // prefix supers -> global chunk ids; build cell_starts
    int64_t* sup_base = new int64_t[n_super + 1];
    sup_base[0] = 0;
    for (int64_t s = 0; s < n_super; ++s)
        sup_base[s + 1] = sup_base[s] + sup_chunks[s];
    const int64_t nc = sup_base[n_super];
    cell_starts[0] = 0;
    for (int64_t i = 0; i < n_super * nct; ++i)
        cell_starts[i + 1] = cell_starts[i] + cell_cnt[i];
#pragma omp parallel for schedule(dynamic, 1)
    for (int64_t s = 0; s < n_super; ++s) {
        const int64_t lo = sup_start[s], hi = sup_start[s + 1];
        for (int64_t e = lo; e < hi; ++e) chunk_of[e] += sup_base[s];
    }
    // rb_locals per chunk (first edge of each chunk defines it)
    if (nc <= rbl_cap) {
#pragma omp parallel for schedule(static)
        for (int64_t e = 0; e < nnz; ++e) {
            if (rank_in_chunk[e] == 0) {
                const int64_t s = row[e] / sb_rows;
                rb_locals[chunk_of[e]] = (int32_t)(row[e] / rb - s * nrb_s);
            }
        }
    }
    delete[] sup_start; delete[] sup_chunks; delete[] cell_cnt;
    delete[] sup_base;
    return nc;
}

// Fill for v2: edges_packed (nc, 3, eb) int32 — plane 0 local cols,
// plane 1 f32 values bit-cast, plane 2 local rows.  Pre-zeroed by caller.
void isplib_plan_v2_fill(const int32_t* row, const int32_t* col,
                         const float* val, int64_t nnz,
                         int32_t rb, int32_t ct, int32_t eb,
                         const int64_t* chunk_of,
                         const int64_t* rank_in_chunk,
                         int32_t* edges_packed /* nc*3*eb */) {
#pragma omp parallel for schedule(static)
    for (int64_t e = 0; e < nnz; ++e) {
        const int64_t c = chunk_of[e];
        const int64_t s = rank_in_chunk[e];
        int32_t* chunk = edges_packed + c * 3 * (int64_t)eb;
        chunk[s] = col[e] - (col[e] / ct) * ct;
        std::memcpy(chunk + eb + s, &val[e], 4);
        chunk[2 * (int64_t)eb + s] = row[e] - (row[e] / rb) * rb;
    }
}

// ---------------------------------------------------------------------------
// R-MAT edge generator (power-law graphs for benchmarks).
// Deterministic per (seed, index) via SplitMix64 — parallel-safe.
// ---------------------------------------------------------------------------
static inline uint64_t splitmix64(uint64_t x) {
    x += 0x9E3779B97f4A7C15ULL;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
    return x ^ (x >> 31);
}

void isplib_rmat(int64_t num_edges, int32_t num_nodes, uint64_t seed,
                 double a, double b, double c,
                 int32_t* out_src, int32_t* out_dst) {
    int scale = 1;
    while ((1LL << scale) < num_nodes) ++scale;
    const double ab = a + b, abc = a + b + c;
#pragma omp parallel for schedule(static)
    for (int64_t e = 0; e < num_edges; ++e) {
        uint64_t state = splitmix64(seed ^ (uint64_t)e * 0x5851F42D4C957F2DULL);
        int64_t src = 0, dst = 0;
        for (int s = 0; s < scale; ++s) {
            state = splitmix64(state);
            const double r = (double)(state >> 11) * (1.0 / 9007199254740992.0);
            const int right = (r >= a && r < ab) || (r >= abc);
            const int down = r >= ab;
            src = src * 2 + down;
            dst = dst * 2 + right;
        }
        out_src[e] = (int32_t)(src % num_nodes);
        out_dst[e] = (int32_t)(dst % num_nodes);
    }
}

// ---------------------------------------------------------------------------
// v3 hybrid BSR plan: native densify path.
//
// Counterpart of sparse/tiling_v3.py's numpy densify pipeline.  Two-phase
// like the other entry points:
//
//   isplib_bsr_count: per-128x128-block edge counts (exact, parallel over
//     block-rows — each block-row owns a disjoint slice of the counts).
//   isplib_bsr_fill:  scatter-accumulate each dense block in an f32
//     scratch tile, round-to-nearest-even to bf16, and write directly in
//     the kernel's grouped (nb/g, 128, g*128) layout; flags every edge
//     that went dense so the caller can extract the residual edge list.
//
// Peak transient memory is one 64 KiB f32 tile per thread.  Duplicate
// edges of a block are summed in f32 in edge order, then rounded once.
// ---------------------------------------------------------------------------
static inline uint16_t f32_to_bf16(float f) {
    uint32_t x;
    std::memcpy(&x, &f, 4);
    if ((x & 0x7F800000u) == 0x7F800000u) {
        // NaN/Inf: pass the truncated bits through (quieting NaNs) —
        // the rounding carry below would otherwise overflow the all-ones
        // exponent into the sign bit, silently turning NaN edge values
        // into -0.0/Inf.
        uint16_t hi = (uint16_t)(x >> 16);
        if ((x & 0x007FFFFFu) != 0 && (hi & 0x7Fu) == 0) hi |= 0x40u;
        return hi;
    }
    const uint32_t lsb = (x >> 16) & 1u;
    x += 0x7FFFu + lsb;  // round to nearest even
    return (uint16_t)(x >> 16);
}

// Block-row edge ranges of a row-sorted edge list (shared helper).
static void blockrow_ranges(const int32_t* row, int64_t nnz, int32_t bs,
                            int64_t n_br, int64_t* start /* n_br+1 */) {
    start[0] = 0;
    int64_t e = 0;
    for (int64_t b = 1; b <= n_br; ++b) {
        const int64_t bound = b * (int64_t)bs;
        while (e < nnz && row[e] < bound) ++e;
        start[b] = e;
    }
}

void isplib_bsr_count(const int32_t* row, const int32_t* col, int64_t nnz,
                      int32_t bs, int64_t n_br, int64_t n_bc,
                      int32_t* counts /* n_br*n_bc, pre-zeroed */) {
    int64_t* brs = new int64_t[n_br + 1];
    blockrow_ranges(row, nnz, bs, n_br, brs);
#pragma omp parallel for schedule(dynamic, 4)
    for (int64_t b = 0; b < n_br; ++b) {
        int32_t* cnt = counts + b * n_bc;
        for (int64_t e = brs[b]; e < brs[b + 1]; ++e) cnt[col[e] / bs]++;
    }
    delete[] brs;
}

// rank: (n_br*n_bc,) int64, output slot of each dense block or -1.
// blocks_out: grouped bf16 layout (nb_padded/g, bs, g*bs), pre-zeroed.
// is_dense: (nnz,) uint8 out — 1 where the edge was densified.
void isplib_bsr_fill(const int32_t* row, const int32_t* col,
                     const float* val, int64_t nnz,
                     int32_t bs, int64_t n_br, int64_t n_bc, int32_t g,
                     const int64_t* rank,
                     uint16_t* blocks_out, uint8_t* is_dense) {
    int64_t* brs = new int64_t[n_br + 1];
    blockrow_ranges(row, nnz, bs, n_br, brs);
    const int64_t bs2 = (int64_t)bs * bs;
#pragma omp parallel
    {
        float* tile = new float[bs2];
        int64_t* cnt = new int64_t[n_bc + 1];
#pragma omp for schedule(dynamic, 2)
        for (int64_t b = 0; b < n_br; ++b) {
            const int64_t lo = brs[b], hi = brs[b + 1];
            if (lo == hi) continue;
            // counting sort of this block-row's edges by block-col
            std::memset(cnt, 0, sizeof(int64_t) * (n_bc + 1));
            for (int64_t e = lo; e < hi; ++e) cnt[col[e] / bs + 1]++;
            for (int64_t c = 0; c < n_bc; ++c) cnt[c + 1] += cnt[c];
            int32_t* idx = new int32_t[hi - lo];
            for (int64_t e = lo; e < hi; ++e)
                idx[cnt[col[e] / bs]++] = (int32_t)(e - lo);
            // cnt[c] is now the END of block c's range (start = cnt[c-1])
            for (int64_t c = 0; c < n_bc; ++c) {
                const int64_t p = rank[b * n_bc + c];
                const int64_t c_lo = c ? cnt[c - 1] : 0, c_hi = cnt[c];
                if (p < 0 || c_lo == c_hi) continue;
                std::memset(tile, 0, sizeof(float) * bs2);
                for (int64_t i = c_lo; i < c_hi; ++i) {
                    const int64_t e = lo + idx[i];
                    const int32_t rl = row[e] - (int32_t)(b * bs);
                    const int32_t cl = col[e] - (int32_t)(c * bs);
                    tile[(int64_t)cl * bs + rl] += val[e];
                    is_dense[e] = 1;
                }
                // grouped layout: member j of group p/g sits at lane band j
                uint16_t* dst = blocks_out
                    + (p / g) * bs * (int64_t)g * bs + (p % g) * bs;
                for (int32_t cl = 0; cl < bs; ++cl) {
                    uint16_t* drow = dst + (int64_t)cl * g * bs;
                    const float* srow = tile + (int64_t)cl * bs;
                    for (int32_t rl = 0; rl < bs; ++rl)
                        drow[rl] = f32_to_bf16(srow[rl]);
                }
            }
            delete[] idx;
        }
        delete[] tile;
        delete[] cnt;
    }
    delete[] brs;
}

// Residual extraction: compact the edges NOT flagged dense (parallel
// two-phase: per-thread counts, prefix, fill).  Keeps CSR order.
int64_t isplib_compact_residual(const int32_t* row, const int32_t* col,
                                const float* val, const uint8_t* is_dense,
                                int64_t nnz, int32_t* out_row,
                                int32_t* out_col, float* out_val) {
    int64_t n = 0;
    for (int64_t e = 0; e < nnz; ++e) {
        if (!is_dense[e]) {
            out_row[n] = row[e];
            out_col[n] = col[e];
            out_val[n] = val[e];
            ++n;
        }
    }
    return n;
}

// Threads of the OpenMP regions that the calling thread starts from now on.
void isplib_set_num_threads(int n) {
#ifdef _OPENMP
    omp_set_num_threads(n > 0 ? n : 1);
#else
    (void)n;
#endif
}

int isplib_version() { return 2; }

}  // extern "C"
