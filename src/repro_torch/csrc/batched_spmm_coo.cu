// Batched COO SpMM — the paper's batched SWA-SpMM for SparseTensor (the
// slots of a matrix in any order), C[s, rid] += val * B[s, cid, :].
//
// Replaces the TPU kernel src/repro/kernels/batched_spmm_coo.py
// (batched_spmm_coo / _kernel, the pallas_coo registry entry), whose
// one-hot MXU contraction stood in for the atomics a TPU lacks.
//
// What bounds it on an H100: bytes, as for the ELL kernel (~1 FMA per 8
// bytes of ids and values). At the main-path shape (512 matrices of 56
// rows, nnz_pad 256, n_b 64) the call moves ~16 MB, ~5 us of HBM time:
// about the cost of one launch, so what bounds it in practice is latency,
// how many independent loads each warp has in flight.
//
// Design: bucket the slots by row in shared memory, then own rows, as the
// CSR, hybrid and ELL kernels do, with B read where it lies (through the
// read-only cache; L2-resident at every size the port runs). A block of
// 256 threads owns some rows of one matrix; sub lanes (a sub-warp) cover a
// panel of at most 128 columns, four neighbouring columns a lane (16-byte
// f32 or 8-byte bf16 loads where n_b allows). It reads its matrix's slot
// stream in runs of up to kRunMax slots (all of it in one run at every
// main-path shape) and buckets the live slots of its rows:
// - each warp takes a contiguous share of the run and counts its slots per
//   (row, warp): in one step of 32 slots by __match_any_sync, the lanes
//   keeping their slots in registers (streams up to 256 slots), else with
//   integer shared atomics (a count is the same in any order);
// - one exclusive scan over the (row, warp) counts gives where each
//   (row, warp) share starts, so a row's slots lie in warp order;
// - each warp places its slots in order, 32 a step, each at its (row,
//   warp) cursor plus its rank among the step's slots of its row
//   (__match_any_sync), then the step's last such lane moves the cursor:
//   every row's slots land in increasing slot index, whatever the order of
//   the stream (the dB / dU calls swap the ids, so their rows come in
//   column order).
// The one-step count, which reads each slot once and places it from
// registers, pays: with every share through the atomic count instead
// (scripts/fused_compare.py, the two in turns on one H100 80GB HBM3 at
// 700 W) Tox21 serving took 0.0070-0.0071 ms against 0.0065, bf16
// 0.0075-0.0076 against 0.0068-0.0069, and dU at Tox21 training 0.0053
// against 0.0049.
// Then each sub-warp walks its rows' bucketed slots in order, kSlots at a
// time with all their B gathers issued before their FMAs, and stores each
// row once when the walk passes its end (a row with no live slot stores
// 0.0). The sum stays in f32 registers from 0.0 in increasing slot index,
// one fmaf chain per output. No float atomics: the result is the same
// bits from run to run and whatever the block split.
//
// The split. Where the stream fits one run (its own template instance:
// with the bucket's operands dead during the walk it fits the 64
// registers of four blocks an SM without spilling), a block buckets it
// once, owns as many rows as leave about kBlocksPerSm blocks an SM (the
// whole matrix at Tox21: 512 and 200 blocks; ~43 rows of the powerlaw
// batch's 256) and walks every column panel itself; a sub-warp owns one
// row, or, with more rows than sub-warps, the rows whose slots start in
// its equal share of the block's slots (a hub row alone, short rows many
// to a sub-warp). A longer stream takes one row a sub-warp, one column
// panel a block, and buckets each run again, the sums carried in
// registers from run to run. On one H100 80GB HBM3 at 700 W
// (scripts/fused_compare.py) the first version of this design (one row a
// sub-warp, four row blocks a matrix, 111 registers: two blocks an SM)
// took 0.0186 ms at Tox21; this one 0.0065, against the atomic kernel's
// 0.0130 and torch.bmm's 0.0095.
//
// A slot whose value is 0.0 (padding) adds nothing, as in the ELL and
// fused kernels: it would add fmaf(0, b, acc) == acc for a finite b. Row
// ids outside [0, m_pad) (the m_pad sentinel the reference's scatter
// drops) and column ids outside it add nothing either.
//
// bf16 entry (batched_spmm_coo_bf16), the reference kernel's other operand
// branches (_kernel :51: int16 row and column ids widened on load (:61),
// bf16 values and B): one template over the value type V, the dense type D
// and the id type I. Values are widened as they are bucketed, B rows are
// read as bf16, the sums stay f32 and each output is rounded to bf16 once
// (__float2bfloat16_rn). It runs the pallas_coo_bf16 forward and dB / dU
// of the pallas_ell_bf16 and fused_bf16 backwards. The m_pad row-id
// sentinel fits int16 because the wrapper's narrowing refuses
// m_pad > 32767.
//
// g-SpMM entry (batched_gspmm_coo_f32), the reference kernel's (op, reduce)
// branches: C[s, r] = reduce_{i < nnz[s], rid[i] = r} op(B[s, cid[i]], e_i)
// with op in {mul, add, copy_lhs}, reduce in {sum, max, mean}, and scalar
// edges e (batch, nnz_pad) or vector edges (batch, nnz_pad, n_b), read per
// slot per column (the bucket holds the slot index). Padding is not inert
// by value outside (mul, sum), so slots at or past nnz[s] are masked
// instead of skipping 0.0 values. One template instance per reduce: sum
// and mean add each message in slot order (the message and the add
// rounded apart, as the plain version rounds them), max takes fmaxf from
// the finite -3e38 (exact in any order, so max corners equal the plain
// version bit for bit). For max and mean the block also counts each of
// its rows' degree: every slot below nnz[s] whose row id, clipped into
// [0, m_pad) as the reference's wrapper does, is that row, the slots with
// out-of-range ids among them; mean divides by max(deg, 1) and max writes
// 0.0 into rows of degree 0.
//
// Large-matrix entries (batched_spmm_coo_large_{f32,bf16},
// batched_gspmm_coo_large_f32), for paper case 3, where the reference takes
// its plain per-sample path (src/repro/kernels/ops.py _forward_base): a
// matrix's stream (~600 KB at 9,000 rows) is far larger than a block
// buckets at a time, and a row block that bucketed all of it would read it
// once per row block. Two kernels, one entry call, the batched entries'
// contract: rows owned, no float atomics, nothing filled before the launch.
// 1. Sort (coo_sort_kernel): one block a (matrix, run of 256 slots; longer
//    past 65,536 slots, so that a matrix has at most 256 runs). It buckets
//    its run by sort tile (group walk tiles, at most 512 sort tiles a
//    matrix) with the batched entry's bucket and moves each slot's row id,
//    column id and held value to its place in the run's share of the
//    sorted arrays (tile order, each tile's slots in increasing slot
//    index), and writes where each tile starts there, the empty tiles too,
//    so that nothing needs zeroing. (mul, sum) sorts the live slots only;
//    g-SpMM every slot below nnz[s], at its row id clipped into [0, m_pad),
//    so that the walk counts the degrees.
// 2. Walk (coo_large_kernel): one block a (matrix, walk tile, column panel
//    of at most 128 columns), launched while the sort runs (programmatic
//    dependent launch: its blocks set up, then wait for the sort's
//    writes). It reads its sort tile's slice of each run (one run a thread,
//    a scan of their lengths), stages kStage slots at a time, buckets the
//    slots of its own rows with the batched entry's bucket and walks them
//    with its walk (kSlots gathers of B through the read-only cache before
//    their FMAs). Each output's sum waits in shared memory (carry) from one
//    stage to the next, its sub-warp continuing the chain, so no row is
//    ever cut: each output is one fmaf chain (g-SpMM: the message and the
//    add rounded apart) from the reduce's identity over its row's live
//    slots in increasing slot index, stored once, finished for mean /
//    empty max and rounded to bf16 once at the store. The bits are those
//    of the batched entry, from run to run and under any tile, run or panel
//    split. A hub row goes whole to one sub-warp, as in the batched entry.
// The walk tiles: as many rows as give about sixteen walk blocks an SM of
// an H100, at least a row a sub-warp (16 rows at n_b 64: the tier's block
// of 33,792 rows), at most 64 rows, more only past 65,535 tiles (at most
// 256 rows): enough blocks an SM to hide each walk block's chain of
// loads (its slices' starts, its staged slots, then its gathers). The
// scratch (the sorted arrays and the (sort tile, run) starts) is the
// wrapper's torch.empty, its size a function of the shapes alone.
#include "common.cuh"

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / repro::kWarp;
constexpr int kMinBlocks = 4;    // blocks an SM: at most 64 registers
constexpr int kSlots = 4;        // slots whose gathers issue together
constexpr int kRunMax = 4096;    // slots bucketed at a time: 32 KB
constexpr int kRowsMax = 256;    // a block's rows when bucketed at once
constexpr int kBlocksPerSm = 2;  // the row blocks' target when bucketed once
constexpr int kSpmm = -1;        // kR of the (mul, sum) entries

using repro::kW;

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

// The shapes one launch shares with its blocks.
struct Shape {
  int nnz_pad, m_pad, n_b, panel, sub, run, vec;
  int op, vec_edges;           // g-SpMM only
  int block_rows;              // rows a block owns
  int group, sort_tiles;       // large-matrix branch: walk tiles a sort
  int runs, sort_run;          // tile, sort tiles, runs and slots a run
};

// Shared memory: (block_rows x kWarps) counts, then the scan's per-warp
// totals, the rows' degrees (g-SpMM), and a run's bucketed column ids and
// values (or, for vector edges, slot indices).
__host__ __device__ constexpr size_t smem_bytes(int rows, int run) {
  return (static_cast<size_t>(rows) * kWarps + kWarps + rows +
          2 * static_cast<size_t>(run)) * sizeof(int);
}
// every launch fits the 48 KB a block takes without opting in to more
static_assert(smem_bytes(kRowsMax, kRunMax) <= 48 * 1024,
              "a block's rows and run outgrow the default shared memory");

// The value a bucket holds for slot i of the matrix at off: (mul, sum) and
// the edge ops its value, g-SpMM vector edges the slot index (as float
// bits), copy_lhs 0.0 (unread).
template <int kR, typename V>
__device__ __forceinline__ float held_value(const V* val, size_t off, int i,
                                            const Shape& sh) {
  if constexpr (kR != kSpmm) {
    if (sh.vec_edges) return __int_as_float(i);
    if (sh.op == repro::kOpCopyLhs) return 0.f;
  }
  return repro::ldv(val + off + i);
}

// A slot with row id r, column id j and held value v as a bucket of the
// block's rows [row0, row0 + rows) sees it: its row in the block, or -1
// where it adds nothing to them (a row outside them, a column id outside
// [0, m_pad), a (mul, sum) value 0.0: padding), and for g-SpMM *cr, the
// block row its degree counts it in (its row id clipped into [0, m_pad);
// -1: none).
template <int kR>
__device__ __forceinline__ int block_row(int r, int j, float v, int row0,
                                         int rows, const Shape& sh,
                                         int* cr) {
  bool live = static_cast<unsigned>(j) < static_cast<unsigned>(sh.m_pad);
  *cr = -1;
  if constexpr (kR != kSpmm) {
    const int c = min(max(r, 0), sh.m_pad - 1) - row0;
    *cr = static_cast<unsigned>(c) < static_cast<unsigned>(rows) ? c : -1;
  } else {
    live = live && v != 0.f;
  }
  const int lr = r - row0;
  return live && static_cast<unsigned>(lr) < static_cast<unsigned>(rows)
             ? lr : -1;
}

// Slot i of matrix s (at off) as the block's bucket sees it (block_row):
// its column id and held value into j and v; g-SpMM masks the slots at or
// past n (the matrix's nnz).
template <int kR, typename V, typename I>
__device__ __forceinline__ int read_slot(const I* rid, const I* cid,
                                         const V* val, size_t off, int i,
                                         bool in, int n, int row0, int rows,
                                         const Shape& sh, int* j, float* v,
                                         int* cr) {
  *j = 0, *v = 0.f, *cr = -1;
  if (!in) return -1;
  const int r = repro::ldi(rid + off + i);
  *j = repro::ldi(cid + off + i);
  if (kR != kSpmm && i >= n) return -1;
  *v = held_value<kR>(val, off, i, sh);
  return block_row<kR>(r, *j, *v, row0, rows, sh, cr);
}

// A slot as a row bucket holds it: its column id and value (g-SpMM vector
// edges: the slot index, as float bits) and the block row its degree counts
// it in (-1: none).
struct RowItem {
  int j, cr;
  float v;
};

// The slots a bucket of the block's rows [row0, row0 + rows) reads:
// position p is slot base + p of the matrix at off, keyed by its row in the
// block (read_slot). Counts the degrees into deg where it is not null
// (zeroed first where `zero`), and places each slot's column id and held
// value into bcol / bval.
template <int kR, typename V, typename I>
struct RowSrc {
  using Item = RowItem;
  const I* rid;
  const I* cid;
  const V* val;
  size_t off;
  int base, n, row0, rows;
  const Shape& sh;
  int* deg;
  bool zero;
  int* bcol;
  float* bval;

  __device__ __forceinline__ int read(int p, bool in, Item& it) const {
    return read_slot<kR>(rid, cid, val, off, base + p, in, n, row0, rows, sh,
                         &it.j, &it.v, &it.cr);
  }
  __device__ __forceinline__ void clear() const {
    if (deg != nullptr && zero)
      for (int i = threadIdx.x; i < rows; i += kThreads) deg[i] = 0;
  }
  __device__ __forceinline__ void count(const Item& it) const {
    if (deg != nullptr && it.cr >= 0) atomicAdd(deg + it.cr, 1);
  }
  __device__ __forceinline__ void put(int at, const Item& it) const {
    bcol[at] = it.j;
    bval[at] = it.v;
  }
};

// Bucket the positions [0, len) of src by their key, one of `keys` (-1:
// none), as the header describes for rows: afterwards
// ends[k * kWarps + kWarps - 1] is where key k's items end (they start
// where key k - 1's end), in increasing position. src reads each item
// (read: its key), counts it (count: the g-SpMM degrees; clear zeroes
// them) and places it (put). Barriers at both ends (at the start only
// where an earlier bucket of the block, not `fresh`, may still be read).
template <typename Src>
__device__ __forceinline__ void bucket(const Src& src, int len, int keys,
                                       bool fresh, int* ends, int* ws) {
  using Item = typename Src::Item;
  const int warp = threadIdx.x / repro::kWarp;
  const int wl = threadIdx.x % repro::kWarp;
  const unsigned below = (1u << wl) - 1u;
  // each warp's contiguous share, whole steps of 32
  const int share = ((len + kWarps - 1) / kWarps + repro::kWarp - 1) /
                    repro::kWarp * repro::kWarp;
  const int lo = warp * share, hi = min(lo + share, len);
  // a share of one step: each lane reads its item once, before the
  // barrier, and places it from registers
  const bool one = share <= repro::kWarp;
  Item i1{};
  const int k1 = one ? src.read(lo + wl, lo + wl < hi, i1) : -1;
  if (!fresh) __syncthreads();   // the last bucket is read
  for (int i = threadIdx.x; i < keys * kWarps; i += kThreads) ends[i] = 0;
  src.clear();
  __syncthreads();
  unsigned p1 = 0;
  if (one) {
    src.count(i1);
    p1 = __match_any_sync(0xffffffffu, k1);
    if (k1 >= 0 && wl == 31 - __clz(p1))
      ends[k1 * kWarps + warp] = __popc(p1);
  } else {
    for (int base = lo; base < hi; base += repro::kWarp) {
      Item it{};
      const int k = src.read(base + wl, base + wl < hi, it);
      src.count(it);
      if (k >= 0) atomicAdd(ends + k * kWarps + warp, 1);
    }
  }
  __syncthreads();
  repro::exclusive_scan<kThreads>(ends, keys * kWarps, ws);
  __syncthreads();
  // each step of 32: an item goes to its (key, warp) cursor plus its rank
  // among the step's items of its key, then the cursor moves on
  const auto place = [&](int k, const Item& it, unsigned peers) {
    if (k >= 0) src.put(ends[k * kWarps + warp] + __popc(peers & below), it);
    __syncwarp();
    if (k >= 0 && wl == 31 - __clz(peers))
      ends[k * kWarps + warp] += __popc(peers);
    __syncwarp();
  };
  if (one) {
    place(k1, i1, p1);
  } else {
    for (int base = lo; base < hi; base += repro::kWarp) {
      Item it{};
      const int k = src.read(base + wl, base + wl < hi, it);
      place(k, it, __match_any_sync(0xffffffffu, k));
    }
  }
  __syncthreads();
}

// Where row r's bucketed slots start and end (r == rows: the end of all).
__device__ __forceinline__ int row_start(const int* ends, int r) {
  return r ? ends[r * kWarps - 1] : 0;
}
__device__ __forceinline__ int row_end(const int* ends, int r) {
  return ends[r * kWarps + kWarps - 1];
}

// The first of the block's rows whose slots start at or past slot t.
__device__ __forceinline__ int first_row(const int* ends, int rows, int t) {
  int lo = 0, hi = rows;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (row_start(ends, mid) >= t)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// The rows [*lo, *hi) that sub-warp g of `groups` owns: row g, or, with
// more rows than sub-warps, the rows whose bucketed slots start in its
// equal share of them (a hub row alone, short rows many to a sub-warp).
__device__ __forceinline__ void own_rows(const int* ends, int rows, int g,
                                         int groups, int* lo, int* hi) {
  *lo = min(g, rows), *hi = min(g + 1, rows);
  if (rows <= groups) return;
  const int total = row_start(ends, rows);
  *lo = first_row(ends, rows, (g * total + groups - 1) / groups);
  *hi = g + 1 < groups
            ? first_row(ends, rows, ((g + 1) * total + groups - 1) / groups)
            : rows;
}

// What a sub-warp's walk over its rows needs besides the bucket.
template <typename V, typename D>
struct Walk {
  const D* bsrc;   // B's panel of this matrix
  D* dst;          // C's panel at the block's first row
  const V* val;    // vector edges (g-SpMM)
  const int* deg;  // the block's rows' degrees (g-SpMM)
  size_t off;      // the matrix's first slot
  int col0, cc, nbw;
};

// op(u, e) of a g-SpMM message, rounded once as PyTorch rounds it. The
// message and the sum's add are intrinsics, which the compiler never fuses
// into an FMA: where it fused them in some unrolled slots of the walk and
// not in others, a row's sum took other bits under another block split.
__device__ __forceinline__ float message(float u, float e, int op) {
  if (op == repro::kOpMul) return __fmul_rn(u, e);
  if (op == repro::kOpAdd) return __fadd_rn(u, e);
  return u;
}

// The identity of reduce kR (the sums: 0.0; max: the finite -3e38).
template <int kR>
__host__ __device__ constexpr float identity() {
  return kR == repro::kMax ? repro::kNegInf : 0.f;
}

// Row r's sum (kW columns of this lane) to C, finished for the g-SpMM
// reduce (max: 0.0 where the degree is 0; mean: over max(deg, 1)), then
// acc back to the reduce's identity.
template <int kR, typename V, typename D>
__device__ __forceinline__ void store_row(float (&acc)[kW], int r,
                                          const Walk<V, D>& w,
                                          const Shape& sh) {
  if constexpr (kR == repro::kMax || kR == repro::kMean) {
    const int d = w.deg[r];
#pragma unroll
    for (int i = 0; i < kW; ++i)
      acc[i] = kR == repro::kMax ? (d > 0 ? acc[i] : 0.f)
                                 : repro::div_count(acc[i], d > 1 ? d : 1);
  }
  repro::store_cols(w.dst + static_cast<size_t>(r) * sh.n_b + w.cc, acc,
                    sh.vec, w.nbw - w.cc);
#pragma unroll
  for (int i = 0; i < kW; ++i) acc[i] = identity<kR>();
}

// The bucketed slots [k0, k1), in order, into acc, the sum of row r:
// kSlots at a time (g-SpMM: half as many, with their edges' values beside
// B's rows: at kSlots they spilled registers), every load before the FMAs;
// a slot past row r's end first hands row r to next(acc, r) (and each row
// after it that has no slot here; next stores the row and sets acc to the
// next row's start) and moves r on.
template <int kR, typename V, typename D, typename Next>
__device__ __forceinline__ void walk(float (&acc)[kW], int& r, int k0,
                                     int k1, const int* ends,
                                     const int* bcol, const float* bval,
                                     const Walk<V, D>& w, const Shape& sh,
                                     const Next& next) {
  constexpr int kS = kR == kSpmm ? kSlots : kSlots / 2;
  for (int kb = k0; kb < k1; kb += kS) {
    bool ok[kS];
    int j[kS];
    float v[kS];
#pragma unroll
    for (int q = 0; q < kS; ++q) {
      ok[q] = kb + q < k1;
      j[q] = ok[q] ? bcol[kb + q] : 0;
      v[q] = ok[q] ? bval[kb + q] : 0.f;
    }
    // B's rows and (g-SpMM) the edges' values, all loads before the FMAs
    float x[kS][kW];
    float ev[kR != kSpmm ? kS : 1][kW];
#pragma unroll
    for (int q = 0; q < kS; ++q) {
      if (!ok[q]) continue;
      repro::load_cols(w.bsrc + static_cast<size_t>(j[q]) * sh.n_b + w.cc,
                       sh.vec, w.nbw - w.cc, x[q]);
      if constexpr (kR != kSpmm) {
        if (sh.vec_edges && sh.op != repro::kOpCopyLhs) {
          const size_t slot = w.off + __float_as_int(v[q]);
          repro::load_cols(w.val + slot * sh.n_b + w.col0 + w.cc, sh.vec,
                           w.nbw - w.cc, ev[q]);
        } else {
#pragma unroll
          for (int c = 0; c < kW; ++c) ev[q][c] = v[q];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kS; ++q) {
      if (!ok[q]) break;
      while (kb + q >= row_end(ends, r)) next(acc, r++);
      if constexpr (kR != kSpmm) {
#pragma unroll
        for (int c = 0; c < kW; ++c) {
          const float m = message(x[q][c], ev[q][c], sh.op);
          acc[c] = kR == repro::kMax ? fmaxf(acc[c], m)
                                     : __fadd_rn(acc[c], m);
        }
      } else {
#pragma unroll
        for (int c = 0; c < kW; ++c) acc[c] = fmaf(v[q], x[q][c], acc[c]);
      }
    }
  }
}

// kR: the g-SpMM entry's reduce (V, D float, I int; with nnz), or kSpmm:
// (mul, sum). kOnce: the stream is one run, bucketed before the panels
// (its own instance, so that the walk does not keep the bucket's operands
// live).
template <int kR, bool kOnce, typename V, typename D, typename I>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
coo_kernel(const I* __restrict__ rid, const I* __restrict__ cid,
           const V* __restrict__ val, const int* __restrict__ nnz,
           const D* __restrict__ b, D* __restrict__ c, Shape sh) {
  extern __shared__ __align__(16) int coo_smem[];
  const int s = blockIdx.x;
  const int lane = threadIdx.x % sh.sub, g = threadIdx.x / sh.sub;
  const int groups = kThreads / sh.sub;
  int* ends = coo_smem;
  int* ws = ends + sh.block_rows * kWarps;
  int* deg = ws + kWarps;
  int* bcol = deg + sh.block_rows;
  float* bval = reinterpret_cast<float*>(bcol + sh.run);
  const size_t off = static_cast<size_t>(s) * sh.nnz_pad;
  const size_t mat = static_cast<size_t>(s) * sh.m_pad;
  constexpr bool kG = kR != kSpmm;
  constexpr bool kDeg = kR == repro::kMax || kR == repro::kMean;
  // the stream's length bounds the runs; nnz (g-SpMM) only masks, so that
  // the slots' loads need not wait for it
  const int n = kG ? __ldg(nnz + s) : sh.nnz_pad;
  const int panels = (sh.n_b + sh.panel - 1) / sh.panel;
  const int cc = kW * lane;
  const int row0 = blockIdx.y * sh.block_rows;
  const int rows = min(sh.block_rows, sh.m_pad - row0);
  // more rows than sub-warps only where the stream is one run
  int lo = min(g, rows), hi = min(g + 1, rows);
  if constexpr (kOnce) {
    bucket(RowSrc<kR, V, I>{rid, cid, val, off, 0, n, row0, rows, sh,
                            kDeg ? deg : nullptr, true, bcol, bval},
           sh.nnz_pad, rows, true, ends, ws);
    own_rows(ends, rows, g, groups, &lo, &hi);
  }
  for (int p = blockIdx.z; p < panels; p += gridDim.z) {
    const int col0 = p * sh.panel;
    const Walk<V, D> w{b + mat * sh.n_b + col0,
                       c + (mat + row0) * sh.n_b + col0, val, deg, off,
                       col0, cc, min(sh.panel, sh.n_b - col0)};
    const bool mine = cc < w.nbw;
    const auto store = [&](float (&a)[kW], int rr) {
      store_row<kR>(a, rr, w, sh);
    };
    int r = lo;
    float acc[kW];
#pragma unroll
    for (int i = 0; i < kW; ++i) acc[i] = identity<kR>();
    if constexpr (kOnce) {
      if (mine)
        walk<kR>(acc, r, row_start(ends, lo), row_start(ends, hi), ends,
                 bcol, bval, w, sh, store);
    } else {
      const bool first = p == static_cast<int>(blockIdx.z);
      for (int b0 = 0; b0 < sh.nnz_pad; b0 += sh.run) {
        // the degrees in the block's first panel only
        bucket(RowSrc<kR, V, I>{rid, cid, val, off, b0, n, row0, rows, sh,
                                kDeg && first ? deg : nullptr, b0 == 0,
                                bcol, bval},
               min(sh.run, sh.nnz_pad - b0), rows, first && b0 == 0, ends,
               ws);
        if (mine)
          walk<kR>(acc, r, row_start(ends, lo), row_start(ends, hi), ends,
                   bcol, bval, w, sh, store);
      }
    }
    if (mine)
      while (r < hi) store(acc, r++);
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

// The launch: panels of at most kPanelMax columns; where the stream fits
// one run, row blocks of up to kRowsMax rows, as few as still give about
// kBlocksPerSm blocks an SM, each walking every panel; else row blocks of
// one row a sub-warp, one panel a block.
template <int kR, typename V, typename D, typename I>
int launch(const void* rid, const void* cid, const void* val, const int* nnz,
           const void* b, void* c, int batch, int nnz_pad, int m_pad,
           int n_b, int n_block, int op, int vec_edges, void* stream) {
  if (n_block < 1 || nnz_pad < 0) return cudaErrorInvalidValue;
  const int panel = min(n_block, repro::kPanelMax);
  const int sub = repro::sub_warp((panel + kW - 1) / kW);
  const int run = max(1, min(nnz_pad, kRunMax));
  const int once = nnz_pad <= run;
  const size_t cols = kW * sizeof(D);
  const int vec = n_b % kW == 0 && panel % kW == 0 && aligned(b, cols) &&
                  aligned(c, cols) && (!vec_edges || aligned(val, cols));
  int rows = kThreads / sub;
  if (once) {
    const long long want = static_cast<long long>(sm_count()) * kBlocksPerSm;
    const long long per = (static_cast<long long>(batch) * m_pad + want - 1) /
                          want;
    rows = static_cast<int>(min(per, static_cast<long long>(kRowsMax)));
    // equal row blocks, none past kRowsMax rows
    const int blocks = max(max(1, m_pad / max(rows, 1)),
                           (m_pad + kRowsMax - 1) / kRowsMax);
    rows = (m_pad + blocks - 1) / blocks;
  }
  rows = max(1, min(rows, m_pad));
  const int blocks = (m_pad + rows - 1) / rows;
  if (blocks > 65535) return cudaErrorInvalidValue;
  const Shape sh{nnz_pad, m_pad, n_b, panel, sub, run, vec, op, vec_edges,
                 rows};
  const dim3 grid(batch, blocks, once ? 1 : (n_b + panel - 1) / panel);
  const auto go = [&](auto kernel) {
    kernel<<<grid, kThreads, smem_bytes(rows, run),
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const I*>(rid), static_cast<const I*>(cid),
        static_cast<const V*>(val), nnz, static_cast<const D*>(b),
        static_cast<D*>(c), sh);
    return cudaGetLastError();
  };
  return once ? go(coo_kernel<kR, true, V, D, I>)
              : go(coo_kernel<kR, false, V, D, I>);
}

}  // namespace

extern "C" int batched_gspmm_coo_f32(const int* rid, const int* cid,
                                     const float* val, const int* nnz,
                                     const float* b, float* c, int batch,
                                     int nnz_pad, int m_pad, int n_b,
                                     int n_block, int op, int reduce,
                                     int vec, void* stream) {
  const auto go = [&](auto r) {
    return launch<decltype(r)::value, float, float, int>(
        rid, cid, val, nnz, b, c, batch, nnz_pad, m_pad, n_b, n_block, op,
        vec, stream);
  };
  if (reduce == repro::kSum)
    return go(std::integral_constant<int, repro::kSum>{});
  if (reduce == repro::kMax)
    return go(std::integral_constant<int, repro::kMax>{});
  if (reduce == repro::kMean)
    return go(std::integral_constant<int, repro::kMean>{});
  return cudaErrorInvalidValue;
}

extern "C" int batched_spmm_coo_f32(const int* rid, const int* cid,
                                    const float* val, const float* b,
                                    float* c, int batch, int nnz_pad,
                                    int m_pad, int n_b, int n_block,
                                    void* stream) {
  return launch<kSpmm, float, float, int>(rid, cid, val, nullptr, b, c,
                                          batch, nnz_pad, m_pad, n_b,
                                          n_block, 0, 0, stream);
}

// rid and cid (batch, nnz_pad) int16, val bf16, b and c (batch, m_pad, n_b)
// bf16
extern "C" int batched_spmm_coo_bf16(const void* rid, const void* cid,
                                     const void* val, const void* b, void* c,
                                     int batch, int nnz_pad, int m_pad,
                                     int n_b, int n_block, void* stream) {
  return launch<kSpmm, __nv_bfloat16, __nv_bfloat16, short>(
      rid, cid, val, nullptr, b, c, batch, nnz_pad, m_pad, n_b, n_block, 0,
      0, stream);
}

namespace {

// The large-matrix branch: its runs, tiles and staging.
constexpr int kRunsMax = kThreads;    // runs of a matrix: one a thread of
                                      // the walk's scan of its slices
constexpr int kSortRun = 256;         // the shortest run: a step a warp
constexpr int kSortTilesMax = 512;    // tiles the sort keys a matrix by:
                                      // its (tile, warp) counts in 16 KB
constexpr int kTileRowsMax = 256;     // rows a walk block owns
constexpr int kTileRowsBalance = 64;  // the most the balance alone asks
constexpr int kTileBlocks = 132 * 16;  // walk blocks the tiles aim at:
                                       // sixteen an SM of an H100
constexpr int kStage = 1024;          // slots a walk block buckets at once

// How the branch cuts a call: rows a walk tile (a walk block's rows),
// walk tiles a matrix, walk tiles a sort tile (the rows the sort keys a
// slot by), sort tiles a matrix, slots a run, runs a matrix, and the column
// panel and its sub-warp width. From the shapes alone; false where m_pad
// outgrows 65,535 walk tiles of kTileRowsMax rows.
struct Part {
  int rows, tiles, group, sort_tiles, run, runs, panel, sub;
};

bool large_part(int batch, int nnz_pad, int m_pad, int n_block, Part* pt) {
  if (batch < 1 || m_pad < 1 || nnz_pad < 0 || n_block < 1) return false;
  const int panel = min(n_block, repro::kPanelMax);
  const int sub = repro::sub_warp((panel + kW - 1) / kW);
  const long long groups = kThreads / sub;
  long long rows = (static_cast<long long>(batch) * m_pad + kTileBlocks - 1) /
                   kTileBlocks;
  rows = min(rows, max(groups, static_cast<long long>(kTileRowsBalance)));
  rows = max(rows, groups);
  rows = max(rows, (m_pad + 65534LL) / 65535);
  if (rows > kTileRowsMax) return false;
  rows = min(rows, static_cast<long long>(m_pad));
  const int tiles = static_cast<int>((m_pad + rows - 1) / rows);
  const int group = (tiles + kSortTilesMax - 1) / kSortTilesMax;
  const int run = max(kSortRun, ((nnz_pad + kRunsMax - 1) / kRunsMax +
                                 kSortRun - 1) / kSortRun * kSortRun);
  *pt = Part{static_cast<int>(rows), tiles, group,
             (tiles + group - 1) / group, run, (nnz_pad + run - 1) / run,
             panel, sub};
  return true;
}

// The walk's shared memory: each output's sum (rows x pitch f32), the
// (row, warp) counts, the scan's per-warp totals, the rows' degrees, each
// run's slice (where it starts in the sorted arrays, where its positions
// start), the staged slots (row id, column id, held value) and the
// bucket's column ids and held values.
__host__ __device__ constexpr size_t large_smem(int rows, int pitch) {
  return (static_cast<size_t>(rows) * pitch + rows * kWarps + kWarps + rows +
          2 * kRunsMax + 1 + 5 * kStage) * sizeof(int);
}

// A slot as the sort moves it: row id, column id, held value.
struct SlotItem {
  int r, j;
  float v;
};

// The slots of one run of a matrix's stream (from base) as the sort reads
// them, keyed by their sort tile (tile_rows rows): (mul, sum) the live
// slots (a value not 0.0, row and column ids inside [0, m_pad)), g-SpMM
// every slot below n at its row id clipped into [0, m_pad) (the walk
// counts the degrees). Each goes to its place in the run's share of the
// sorted arrays (prow, pcol, pval at the run).
template <int kR, typename V, typename I>
struct TileSrc {
  using Item = SlotItem;
  const I* rid;
  const I* cid;
  const V* val;
  size_t off;
  int base, n, tile_rows;
  const Shape& sh;
  int* prow;
  int* pcol;
  float* pval;

  __device__ __forceinline__ int read(int p, bool in, Item& it) const {
    const int i = base + p;
    if (!in) return -1;
    it.r = repro::ldi(rid + off + i);
    it.j = repro::ldi(cid + off + i);
    const unsigned m = sh.m_pad;
    if constexpr (kR != kSpmm) {
      if (i >= n) return -1;
      it.v = held_value<kR>(val, off, i, sh);
      return min(max(it.r, 0), sh.m_pad - 1) / tile_rows;
    } else {
      it.v = repro::ldv(val + off + i);
      const bool live = it.v != 0.f && static_cast<unsigned>(it.r) < m &&
                        static_cast<unsigned>(it.j) < m;
      return live ? it.r / tile_rows : -1;
    }
  }
  __device__ __forceinline__ void clear() const {}
  __device__ __forceinline__ void count(const Item&) const {}
  __device__ __forceinline__ void put(int at, const Item& it) const {
    prow[at] = it.r;
    pcol[at] = it.j;
    pval[at] = it.v;
  }
};

// The staged slots (srow, scol, sval, shared memory) a walk block's bucket
// reads, keyed by their row in the block (block_row); the degrees and the
// placing as RowSrc's.
template <int kR>
struct StageSrc {
  using Item = RowItem;
  const int* srow;
  const int* scol;
  const float* sval;
  int row0, rows;
  const Shape& sh;
  int* deg;
  int* bcol;
  float* bval;

  __device__ __forceinline__ int read(int p, bool in, Item& it) const {
    it.j = 0, it.v = 0.f, it.cr = -1;
    if (!in) return -1;
    it.j = scol[p], it.v = sval[p];
    return block_row<kR>(srow[p], it.j, it.v, row0, rows, sh, &it.cr);
  }
  __device__ __forceinline__ void clear() const {}
  __device__ __forceinline__ void count(const Item& it) const {
    if (deg != nullptr && it.cr >= 0) atomicAdd(deg + it.cr, 1);
  }
  __device__ __forceinline__ void put(int at, const Item& it) const {
    bcol[at] = it.j;
    bval[at] = it.v;
  }
};

// Sort: one block a (matrix s, run q). Its run's slots, in sort-tile
// order and each tile's in increasing slot index, go to [q run, q run +
// count) of the matrix's sorted arrays; starts[s, t, q] is where sort tile
// t's start there (t = sort_tiles: the run's count).
template <int kR, typename V, typename I>
__global__ void __launch_bounds__(kThreads)
coo_sort_kernel(const I* __restrict__ rid, const I* __restrict__ cid,
                const V* __restrict__ val, const int* __restrict__ nnz,
                int* __restrict__ prow, int* __restrict__ pcol,
                float* __restrict__ pval, int* __restrict__ starts,
                Shape sh) {
  extern __shared__ __align__(16) int coo_smem[];
  // the walk may launch now: it waits for this grid's writes itself
  asm volatile("griddepcontrol.launch_dependents;");
  const int s = blockIdx.x, q = blockIdx.y;
  int* ends = coo_smem;
  int* ws = ends + sh.sort_tiles * kWarps;
  const size_t off = static_cast<size_t>(s) * sh.nnz_pad;
  const int b0 = q * sh.sort_run;
  const int n = kR != kSpmm ? __ldg(nnz + s) : sh.nnz_pad;
  bucket(TileSrc<kR, V, I>{rid, cid, val, off, b0, n,
                           sh.block_rows * sh.group, sh, prow + off + b0,
                           pcol + off + b0, pval + off + b0},
         min(sh.sort_run, sh.nnz_pad - b0), sh.sort_tiles, true, ends, ws);
  int* st = starts + static_cast<size_t>(s) * (sh.sort_tiles + 1) * sh.runs +
            q;
  for (int t = threadIdx.x; t <= sh.sort_tiles; t += kThreads)
    st[static_cast<size_t>(t) * sh.runs] = row_start(ends, t);
}

// Walk: one block a (matrix s, walk tile t, column panel). Its sort tile
// ts = t / group holds its slots: slice q of each run q, from
// starts[s, ts, q] to starts[s, ts + 1, q]; scanned, they are the
// positions [0, total) of the tile's stream, in increasing slot index,
// staged and bucketed (the block's rows only) kStage at a time. carry holds
// each output's sum between stages; a sub-warp takes its rows from carry
// and hands them back (the sums carried exactly, so each is one chain in
// slot order), and the block stores every row once at the end.
template <int kR, typename V, typename D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
coo_large_kernel(const int* __restrict__ prow, const int* __restrict__ pcol,
                 const float* __restrict__ pval, const V* __restrict__ val,
                 const D* __restrict__ b, D* __restrict__ c,
                 const int* __restrict__ starts, Shape sh) {
  extern __shared__ __align__(16) int coo_smem[];
  constexpr bool kDeg = kR == repro::kMax || kR == repro::kMean;
  const int s = blockIdx.x, t = blockIdx.y;
  const int lane = threadIdx.x % sh.sub, g = threadIdx.x / sh.sub;
  const int groups = kThreads / sh.sub;
  const int pitch = (sh.panel + kW - 1) / kW * kW;
  const int row0 = t * sh.block_rows;
  const int rows = min(sh.block_rows, sh.m_pad - row0);
  float* carry = reinterpret_cast<float*>(coo_smem);
  int* ends = coo_smem + sh.block_rows * pitch;
  int* ws = ends + sh.block_rows * kWarps;
  int* deg = ws + kWarps;
  int* sbase = deg + sh.block_rows;
  int* spos = sbase + kRunsMax;
  int* srow = spos + kRunsMax + 1;
  int* scol = srow + kStage;
  float* sval = reinterpret_cast<float*>(scol + kStage);
  int* bcol = scol + 2 * kStage;
  float* bval = reinterpret_cast<float*>(bcol + kStage);
  const size_t off = static_cast<size_t>(s) * sh.nnz_pad;
  const size_t mat = static_cast<size_t>(s) * sh.m_pad;
  const int col0 = blockIdx.z * sh.panel;
  const int cc = kW * lane;
  const Walk<V, D> w{b + mat * sh.n_b + col0,
                     c + (mat + row0) * sh.n_b + col0, val, deg, off, col0,
                     cc, min(sh.panel, sh.n_b - col0)};
  const bool mine = cc < w.nbw;
  const int* st = starts +
                  (static_cast<size_t>(s) * (sh.sort_tiles + 1) +
                   t / sh.group) * sh.runs;
  for (int i = threadIdx.x; i < rows * pitch; i += kThreads)
    carry[i] = identity<kR>();
  if constexpr (kDeg)
    for (int i = threadIdx.x; i < rows; i += kThreads) deg[i] = 0;
  // the sort's writes (launched early, behind it on the stream)
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int q = threadIdx.x; q <= sh.runs; q += kThreads) {
    int len = 0;   // q == runs: the scan's total
    if (q < sh.runs) {
      const int a = __ldg(st + q);
      len = __ldg(st + sh.runs + q) - a;
      sbase[q] = q * sh.sort_run + a;
    }
    spos[q] = len;
  }
  __syncthreads();
  repro::exclusive_scan<kThreads>(spos, sh.runs + 1, ws);
  __syncthreads();
  const int total = spos[sh.runs];
  for (int k0 = 0; k0 < total; k0 += kStage) {
    const int len = min(kStage, total - k0);
    for (int k = threadIdx.x; k < len; k += kThreads) {
      const int p = k0 + k;
      int lo = 0, hi = sh.runs - 1;   // the last slice that starts by p
      while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (spos[mid] <= p)
          lo = mid;
        else
          hi = mid - 1;
      }
      const size_t at = off + sbase[lo] + (p - spos[lo]);
      srow[k] = __ldg(prow + at);
      scol[k] = __ldg(pcol + at);
      sval[k] = __ldg(pval + at);
    }
    __syncthreads();   // staged; the last stage's walk is done
    bucket(StageSrc<kR>{srow, scol, sval, row0, rows, sh,
                        kDeg ? deg : nullptr, bcol, bval},
           len, rows, true, ends, ws);
    int lo, hi;
    own_rows(ends, rows, g, groups, &lo, &hi);
    if (mine && lo < hi) {
      // row rr's sum back to carry, and acc to the next row's
      const auto keep = [&](float (&a)[kW], int rr) {
        repro::st4(carry + rr * pitch + cc, a);
        if (rr + 1 < hi) repro::ld4(a, carry + (rr + 1) * pitch + cc);
      };
      float acc[kW];
      repro::ld4(acc, carry + lo * pitch + cc);
      int r = lo;
      walk<kR>(acc, r, row_start(ends, lo), row_start(ends, hi), ends, bcol,
               bval, w, sh, keep);
      while (r < hi) keep(acc, r++);
    }
  }
  __syncthreads();
  if (mine)
    for (int r = g; r < rows; r += groups) {
      float acc[kW];
      repro::ld4(acc, carry + r * pitch + cc);
      store_row<kR>(acc, r, w, sh);
    }
}

// The two launches. scratch: the sorted row ids, column ids and held
// values (batch, nnz_pad) each, then starts (batch, sort tiles + 1, runs),
// 4-byte words.
template <int kR, typename V, typename D, typename I>
int large_launch(const void* rid, const void* cid, const void* val,
                 const int* nnz, const void* b, void* c, int* scratch,
                 int batch, int nnz_pad, int m_pad, int n_b, int n_block,
                 int op, int vec_edges, void* stream_ptr) {
  Part pt;
  if (!large_part(batch, nnz_pad, m_pad, n_block, &pt) || n_b < 1)
    return cudaErrorInvalidValue;
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t cols = kW * sizeof(D);
  const int vec = n_b % kW == 0 && pt.panel % kW == 0 && aligned(b, cols) &&
                  aligned(c, cols) && (!vec_edges || aligned(val, cols));
  Shape sh{nnz_pad, m_pad, n_b, pt.panel, pt.sub, kStage, vec, op,
           vec_edges, pt.rows};
  sh.group = pt.group, sh.sort_tiles = pt.sort_tiles;
  sh.runs = pt.runs, sh.sort_run = pt.run;
  const size_t slots = static_cast<size_t>(batch) * nnz_pad;
  int* prow = scratch;
  int* pcol = prow + slots;
  float* pval = reinterpret_cast<float*>(pcol + slots);
  int* starts = pcol + 2 * slots;
  const auto* vi = static_cast<const V*>(val);
  cudaError_t e;
  if (pt.runs > 0) {
    const auto sort_k = coo_sort_kernel<kR, V, I>;
    sort_k<<<dim3(batch, pt.runs), kThreads,
             (pt.sort_tiles * kWarps + kWarps) * sizeof(int), stream>>>(
        static_cast<const I*>(rid), static_cast<const I*>(cid), vi, nnz,
        prow, pcol, pval, starts, sh);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  const auto walk_k = coo_large_kernel<kR, V, D>;
  const size_t bytes = large_smem(pt.rows, (pt.panel + kW - 1) / kW * kW);
  if ((e = repro::allow_smem(walk_k, bytes)) != cudaSuccess) return e;
  // launched while the sort runs (programmatic dependent launch): its
  // blocks set up, then wait for the sort's writes
  cudaLaunchAttribute early{};
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch, pt.tiles, (n_b + pt.panel - 1) / pt.panel);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = &early;
  cfg.numAttrs = pt.runs > 0;
  return cudaLaunchKernelEx(&cfg, walk_k, static_cast<const int*>(prow),
                            static_cast<const int*>(pcol),
                            static_cast<const float*>(pval), vi,
                            static_cast<const D*>(b), static_cast<D*>(c),
                            static_cast<const int*>(starts), sh);
}

}  // namespace

// 4-byte words of scratch a large-matrix entry takes a matrix; -1 where the
// shapes outgrow the branch (m_pad past 65,535 walk tiles of 256 rows).
extern "C" int batched_spmm_coo_large_scratch(int batch, int nnz_pad,
                                              int m_pad, int n_block) {
  Part pt;
  if (!large_part(batch, nnz_pad, m_pad, n_block, &pt)) return -1;
  return 3 * nnz_pad + (pt.sort_tiles + 1) * pt.runs;
}

// The large-matrix entries: the batched entries' operands, and scratch
// (torch.empty) of batch x batched_spmm_coo_large_scratch 4-byte words.
extern "C" int batched_spmm_coo_large_f32(const int* rid, const int* cid,
                                          const float* val, const float* b,
                                          float* c, int* scratch, int batch,
                                          int nnz_pad, int m_pad, int n_b,
                                          int n_block, void* stream) {
  return large_launch<kSpmm, float, float, int>(
      rid, cid, val, nullptr, b, c, scratch, batch, nnz_pad, m_pad, n_b,
      n_block, 0, 0, stream);
}

// rid and cid int16, or int32 where ids32 (m_pad past int16's range)
extern "C" int batched_spmm_coo_large_bf16(const void* rid, const void* cid,
                                           const void* val, const void* b,
                                           void* c, int* scratch, int batch,
                                           int nnz_pad, int m_pad, int n_b,
                                           int n_block, int ids32,
                                           void* stream) {
  using B = __nv_bfloat16;
  return ids32 ? large_launch<kSpmm, B, B, int>(
                     rid, cid, val, nullptr, b, c, scratch, batch, nnz_pad,
                     m_pad, n_b, n_block, 0, 0, stream)
               : large_launch<kSpmm, B, B, short>(
                     rid, cid, val, nullptr, b, c, scratch, batch, nnz_pad,
                     m_pad, n_b, n_block, 0, 0, stream);
}

extern "C" int batched_gspmm_coo_large_f32(
    const int* rid, const int* cid, const float* val, const int* nnz,
    const float* b, float* c, int* scratch, int batch, int nnz_pad,
    int m_pad, int n_b, int n_block, int op, int reduce, int vec,
    void* stream) {
  const auto go = [&](auto r) {
    return large_launch<decltype(r)::value, float, float, int>(
        rid, cid, val, nnz, b, c, scratch, batch, nnz_pad, m_pad, n_b,
        n_block, op, vec, stream);
  };
  if (reduce == repro::kSum)
    return go(std::integral_constant<int, repro::kSum>{});
  if (reduce == repro::kMax)
    return go(std::integral_constant<int, repro::kMax>{});
  if (reduce == repro::kMean)
    return go(std::integral_constant<int, repro::kMean>{});
  return cudaErrorInvalidValue;
}
