// Seed-tracker folds of the pooled and the classic step (Hopper, sm_90a).
//
// Two entries share one kernel template and one per-row update (fold_row):
//   tracker_fold_compact <- uncalled_tpu/ops/tracker_kernel.py:_kernel_c
//     (built by _build_c, called through tracker_run_compact from the
//     pooled step): read b's rows are rr_*[clamp(st_w[b] + r, 0, RT-1)],
//     r < rows_eff[b];
//   tracker_fold_rows    <- uncalled_tpu/ops/tracker_kernel.py:_kernel
//     (built by _build, called through tracker_run; the classic step's
//     row fold): read b's rows are the [B, R] streams at b*R + r,
//     r < min(rows_r[b], R), each gated by row_ok (a gated-off row only
//     replays len_sum's ((x + 0) + 0) - 0).
// Each row folds into the read's [CL] cluster table:
// SeedTracker::add_seed (seed_tracker.cpp:157-232) with
// SeedCluster::update (:56-73).  Per row: the eligible cluster with the
// largest total wins (ties: largest r1, then largest evt_en, then first
// index); the reinsertion collision makes it a zombie; with no match the
// seed is inserted into a free slot or evicts the smallest cluster (first
// index; ovf bit 1 when no slot is free); len_sum is f32 in the
// reference's order ((len_sum + upd) + ins) - evicted; the best-cluster
// mm_* snapshot follows.
//
// What bounds it on this card: not bytes (the tables are read and written
// once, a few microseconds at 3.35 TB/s) but the latency of each read's
// row chain.  A read folds its rows strictly in order, so the kernel takes
// (rows of the longest read) x (latency of one row).  The design keeps
// that latency free of device memory and of serial work:
//
// - One block per read.  Thread t owns clusters t, t + threads, ...: only
//   the owner ever reads or writes a cluster inside the row loop, so the
//   table needs no barrier.  threads (ops/tracker_kernel.py fold_launch):
//   the smallest power of two >= CL/4 in [32, 1024], halved while the
//   batch would put more than 16 warps on each of the 132 SMs.  A row is
//   a latency chain when few warps share an SM (four clusters a thread
//   keep the scan short) but issue-bound when many do, since every warp
//   pays the reductions and the update: a wide batch gives each thread
//   more clusters instead.
// - Each row: every thread scans its own clusters for the best eligible
//   one (strict improvement keeps the first index) and the smallest
//   evict key; the warp reduces the match key (flip(total), flip(r1),
//   flip(evt_en), ~index) by a cascade of redux.sync max and the evict
//   key (flip(total or NEG), index << 2 | count << 1 | valid) by redux.sync
//   min, one instruction a word; one lane writes the warp's partial to
//   shared memory (double-buffered by row parity); ONE block barrier;
//   then every warp reduces the warps' partials the same way.  Every
//   thread now holds the winner and the matched cluster's (r2e, ref_st,
//   evt_st), which its owner put in its warp's partial: the owner alone
//   writes the cluster, and every thread updates its own register copy
//   of the tracker scalars (len_sum, n_cl, mm_*, ovf, ovf_why)
//   identically.  No thread works alone while the others wait.
// - The rows are staged in shared memory ahead of the chain, one chunk of
//   `threads` rows at a time (one row a thread, two barriers a chunk).
// - Shared-memory form (CL <= 8192, ops/tracker_kernel.py
//   SHARED_MAX_CL): the table (25 bytes a cluster, the valid and count
//   flags in one byte: 200 KB at CL=8192, 221,184 bytes with the staging
//   and the partials at 1024 threads, under the 232,448 a block may take)
//   is loaded once with 16-byte loads where the layout is aligned and
//   stored once at the end; the per-row loop touches no device memory.
//   8192 is the largest power of two that fits.
// - Device-memory form (CL > 8192: the pooled eject tiers' 16384 and
//   65536): the table lives in the output arrays, each thread copies its
//   own clusters there and its scan reads them from L1/L2; the row staging
//   and the reductions are the same.
// - A read with no rows is copied through, table and scalars.
// Each read stops at its own row count: no batch maximum, no host sync.
// Integer arithmetic wraps like JAX's int32 (done in unsigned); f32 is
// IEEE (never built with fast math; explicit round-to-nearest adds).
// The match pick is the lexicographic maximum over eligible clusters,
// which equals the plain fold's NEG-masked cascade wherever the winner's
// total, r1 and evt_en are >= NEG (-2^30), as every fold state is.

#include <cuda_runtime.h>
#include <stdint.h>

#define NEG (-(1 << 30))
#define FULL_MASK 0xffffffffu

struct TrackerArgs {
  // inputs: 8 tables [B, CL], then 10 per-read scalars [B]
  const uint8_t* v_in;
  const uint8_t* c_in;
  const int32_t* rst_in;
  const int32_t* r1_in;
  const int32_t* r2e_in;
  const int32_t* est_in;
  const int32_t* e1_in;
  const int32_t* tot_in;
  const float* ls_in;
  const int32_t* ncl_in;
  const int32_t* mml_in;
  const int32_t* mmrst_in;
  const int32_t* mmr1_in;
  const int32_t* mmr2e_in;
  const int32_t* mmest_in;
  const int32_t* mme1_in;
  const uint8_t* ovf_in;
  const int32_t* ovfw_in;
  // outputs, same order
  uint8_t* v;
  uint8_t* c;
  int32_t* rst;
  int32_t* r1;
  int32_t* r2e;
  int32_t* est;
  int32_t* e1;
  int32_t* tot;
  float* ls;
  int32_t* ncl;
  int32_t* mml;
  int32_t* mmrst;
  int32_t* mmr1;
  int32_t* mmr2e;
  int32_t* mmest;
  int32_t* mme1;
  uint8_t* ovf;
  int32_t* ovfw;
  // row streams: compact [RT] with per-read windows st_w/rows_eff [B]
  // (tracker_fold_compact), or expanded [B, R] with row_ok [B, R] and
  // rows_r [B] (tracker_fold_rows)
  const int32_t* ren;
  const int32_t* mc;
  const int32_t* evt;
  const int32_t* st_w;
  const int32_t* rows_eff;
  const uint8_t* row_ok;
  const int32_t* rows_r;
  int B, CL, RT, R, min_aln_len;
};

// One warp's scan result, written by one lane, read by every warp after
// the row's barrier: the match key (flip(total), flip(r1), flip(evt_en),
// ~index; all 0: no match), the evict key (flip(total or NEG),
// index << 2 | count << 1 | valid), the collision count, the free-slot
// flag, and the warp's matched cluster's r2e, ref_st, evt_st.
struct Partial {
  unsigned mt, mr, me, mi, eh, el;
  int ncoll, anyfree, r2e, rst, est, pad;
};
static_assert(sizeof(Partial) == 48, "Partial (ops/tracker_kernel.py)");

// In the shared-memory form v holds both flags (bit 0 valid, bit 1
// count) and cnt is unused; in device memory they are the two outputs.
struct Table {
  uint8_t* v;
  uint8_t* cnt;
  int32_t* rst;
  int32_t* r1;
  int32_t* r2e;
  int32_t* est;
  int32_t* e1;
  int32_t* tot;
};

// the tracker scalars: one identical register copy in every thread
struct Scalars {
  float ls;
  int ncl, mml, mmrst, mmr1, mmr2e, mmest, mme1, ovf, ovfw;
};

__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
// signed order as unsigned order
__device__ __forceinline__ unsigned flip(int x) {
  return (unsigned)x ^ 0x80000000u;
}
__device__ __forceinline__ int unflip(unsigned x) {
  return (int)(x ^ 0x80000000u);
}

// The warp's lexicographic max of the match key and min of the evict key
// (redux.sync: one instruction a word, every lane gets the result), its
// collision count and free-slot flag.  Lanes without a candidate hold
// (0, 0, 0, 0) and (~0, ~0); a real match key has mi = ~index > 0 and a
// real evict key el = index << 2 | bits < ~0, so neither sentinel wins.
__device__ __forceinline__ void warp_reduce(Partial& p) {
  const unsigned mt = __reduce_max_sync(FULL_MASK, p.mt);
  const unsigned mr = __reduce_max_sync(FULL_MASK, p.mt == mt ? p.mr : 0u);
  const bool tie2 = p.mt == mt && p.mr == mr;
  const unsigned me = __reduce_max_sync(FULL_MASK, tie2 ? p.me : 0u);
  p.mi = __reduce_max_sync(FULL_MASK, tie2 && p.me == me ? p.mi : 0u);
  p.mt = mt;
  p.mr = mr;
  p.me = me;
  const unsigned eh = __reduce_min_sync(FULL_MASK, p.eh);
  p.el = __reduce_min_sync(FULL_MASK, p.eh == eh ? p.el : ~0u);
  p.eh = eh;
  p.ncoll = (int)__reduce_add_sync(FULL_MASK, (unsigned)p.ncoll);
  p.anyfree = __any_sync(FULL_MASK, p.anyfree);
}

// cluster c's flags: bit 0 valid, bit 1 count
template <bool SHARED>
__device__ __forceinline__ unsigned flags_of(const Table& t, int c) {
  if (SHARED) return t.v[c];
  return (unsigned)t.v[c] | ((unsigned)t.cnt[c] << 1);
}

// Fold one seed row (ref_en, mcv, e2) into the read's table.  Every
// thread of the block calls it; one barrier inside.  part: this row's
// parity half of the [2][warps] partials.
template <bool SHARED>
__device__ __forceinline__ void fold_row(const Table& t, Scalars& sc, int CL,
                                         int min_aln_len, int ref_en,
                                         int mcv, int e2, Partial* part) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int r2 = wadd(wsub(ref_en, mcv), 1);  // new.ref_en_start
  const int r2e = ref_en;                     // new.ref_en_end

  // the thread's own clusters, ascending: a strict improvement keeps the
  // first index of equal keys
  bool has = false;
  int bt = 0, br = 0, be = 0, bi = 0;
  unsigned eh = ~0u, el = ~0u;
  int ncoll = 0, anyfree = 0;
#pragma unroll 4
  for (int c = tid; c < CL; c += nt) {
    const unsigned f = flags_of<SHARED>(t, c);
    const int r1c = t.r1[c], e1c = t.e1[c], totc = t.tot[c];
    const int dr = wsub(r2, r1c);
    const int de = wsub(e2, e1c);
    // eligible: valid, considered (r1 < r2, or r1 == r2 and e1 <= e2) and
    // in range (e1 <= e2, dr <= de, dr >= de/12); with e1 <= e2 a
    // conjunct, considered is r1 <= r2.  trunc vs floor of de/12 differs
    // only at de < 0, where e1 <= e2 is already false
    if ((f & 1) && r1c <= r2 && e1c <= e2 && dr <= de && dr >= de / 12) {
      // a collision (valid, key == (r2, e2)) is always eligible
      ncoll += (dr == 0 && de == 0) ? 1 : 0;
      if (!has || totc > bt ||
          (totc == bt && (r1c > br || (r1c == br && e1c > be)))) {
        has = true;
        bt = totc;
        br = r1c;
        be = e1c;
        bi = c;
      }
    }
    const unsigned ef = flip((f & 2) ? totc : NEG);
    if (ef < eh || el == ~0u) {
      eh = ef;
      el = ((unsigned)c << 2) | (f & 3);
    }
    anyfree |= (f & 2) ? 0 : 1;
  }
  Partial p;
  p.r2e = p.rst = p.est = p.pad = 0;
  p.mt = has ? flip(bt) : 0u;
  p.mr = has ? flip(br) : 0u;
  p.me = has ? flip(be) : 0u;
  p.mi = has ? ~(unsigned)bi : 0u;
  p.eh = eh;
  p.el = el;
  p.ncoll = ncoll;
  p.anyfree = anyfree;
  warp_reduce(p);
  {
    // the warp's matched cluster lies with the lane that owns it
    const int widx = (int)~p.mi;
    if (lane == (p.mi ? (widx & 31) : 0)) {
      if (p.mi) {
        p.r2e = t.r2e[widx];
        p.rst = t.rst[widx];
        p.est = t.est[widx];
      }
      part[tid >> 5] = p;
    }
  }
  __syncthreads();

  // every warp combines the warps' partials (lane w reads warp w's)
  Partial g;
  if (lane < (nt >> 5)) {
    g = part[lane];
  } else {
    g.mt = g.mr = g.me = g.mi = 0u;
    g.eh = g.el = ~0u;
    g.ncoll = g.anyfree = 0;
  }
  warp_reduce(g);

  if (g.mi) {
    // SeedCluster::update on the matched cluster
    const int m = (int)~g.mi;
    const Partial& pw = part[(m & (nt - 1)) >> 5];
    const int a_r2e = pw.r2e;
    const int tot_m = unflip(g.mt);
    const int r1_m = unflip(g.mr);
    const int e1_m = unflip(g.me);
    const bool overlaps = r2 < a_r2e;
    const bool grows = r2e > a_r2e;
    const int growth = overlaps ? (grows ? wsub(r2e, a_r2e) : 0) : mcv;
    // the collision count included the matched cluster (valid, being
    // eligible) when its OLD key equals (r2, e2)
    const int self_coll = (r1_m == r2 && e1_m == e2) ? 1 : 0;
    const bool lost = (g.ncoll - self_coll) > 0;
    const int new_r2e = (grows || !overlaps) ? r2e : a_r2e;
    const int new_tot = wadd(tot_m, growth);
    if (tid == (m & (nt - 1))) {
      t.r1[m] = r2;
      t.r2e[m] = new_r2e;
      t.e1[m] = e2;
      t.tot[m] = new_tot;
      if (lost) t.v[m] &= ~1;  // either form: bit 0 of v is valid
    }
    sc.ls = __fsub_rn(__fadd_rn(__fadd_rn(sc.ls, (float)growth), 0.0f),
                      0.0f);
    sc.ncl = wsub(sc.ncl, lost ? 1 : 0);
    if (growth > 0 && new_tot >= min_aln_len && new_tot > sc.mml) {
      sc.mml = new_tot;
      sc.mmrst = pw.rst;
      sc.mmr1 = r2;
      sc.mmr2e = new_r2e;
      sc.mmest = pw.est;
      sc.mme1 = e2;
    }
  } else {
    // insert into a free slot, else evict the smallest cluster
    const int m = (int)(g.el >> 2);
    const int evicted_len = (g.el & 2) ? unflip(g.eh) : 0;
    const int evicted_n = (int)(g.el & 1);
    if (!g.anyfree) {
      sc.ovf = 1;
      sc.ovfw |= 1;
    }
    if (tid == (m & (nt - 1))) {
      if (SHARED) {
        t.v[m] = 3;
      } else {
        t.v[m] = 1;
        t.cnt[m] = 1;
      }
      t.r1[m] = r2;
      t.r2e[m] = r2e;
      t.rst[m] = r2;
      t.est[m] = e2;
      t.e1[m] = e2;
      t.tot[m] = mcv;
    }
    sc.ls = __fsub_rn(__fadd_rn(__fadd_rn(sc.ls, 0.0f), (float)mcv),
                      (float)evicted_len);
    sc.ncl = wsub(wadd(sc.ncl, 1), evicted_n);
    if (mcv >= min_aln_len && mcv > sc.mml) {
      sc.mml = mcv;
      sc.mmrst = r2;
      sc.mmr1 = r2;
      sc.mmr2e = r2e;
      sc.mmest = e2;
      sc.mme1 = e2;
    }
  }
}

// n elements src -> dst by the whole block, 16 bytes a move where both
// ends are 16-byte aligned
template <typename T>
__device__ __forceinline__ void block_copy(T* dst, const T* src, int n) {
  constexpr int V = 16 / sizeof(T);
  const int tid = threadIdx.x, nt = blockDim.x;
  int head = 0;
  if (((reinterpret_cast<uintptr_t>(dst) |
        reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const int nv = n / V;
    for (int i = tid; i < nv; i += nt)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
    head = nv * V;
  }
  for (int i = head + tid; i < n; i += nt) dst[i] = src[i];
}

// the two flag arrays <-> one flags byte a cluster (bools are 0 or 1, so
// whole words combine without carries)
__device__ __forceinline__ void load_flags(uint8_t* fl, const uint8_t* v,
                                           const uint8_t* cnt, int n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  int head = 0;
  if (((reinterpret_cast<uintptr_t>(fl) | reinterpret_cast<uintptr_t>(v) |
        reinterpret_cast<uintptr_t>(cnt)) & 15) == 0) {
    const int nv = n / 16;
    for (int i = tid; i < nv; i += nt) {
      const uint4 a = reinterpret_cast<const uint4*>(v)[i];
      const uint4 b = reinterpret_cast<const uint4*>(cnt)[i];
      reinterpret_cast<uint4*>(fl)[i] = make_uint4(
          a.x | (b.x << 1), a.y | (b.y << 1), a.z | (b.z << 1),
          a.w | (b.w << 1));
    }
    head = nv * 16;
  }
  for (int i = head + tid; i < n; i += nt) fl[i] = v[i] | (cnt[i] << 1);
}

__device__ __forceinline__ void store_flags(uint8_t* v, uint8_t* cnt,
                                            const uint8_t* fl, int n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  int head = 0;
  if (((reinterpret_cast<uintptr_t>(fl) | reinterpret_cast<uintptr_t>(v) |
        reinterpret_cast<uintptr_t>(cnt)) & 15) == 0) {
    const int nv = n / 16;
    const unsigned one = 0x01010101u;
    for (int i = tid; i < nv; i += nt) {
      const uint4 f = reinterpret_cast<const uint4*>(fl)[i];
      reinterpret_cast<uint4*>(v)[i] =
          make_uint4(f.x & one, f.y & one, f.z & one, f.w & one);
      reinterpret_cast<uint4*>(cnt)[i] =
          make_uint4((f.x >> 1) & one, (f.y >> 1) & one, (f.z >> 1) & one,
                     (f.w >> 1) & one);
    }
    head = nv * 16;
  }
  for (int i = head + tid; i < n; i += nt) {
    v[i] = fl[i] & 1;
    cnt[i] = (fl[i] >> 1) & 1;
  }
}

// the read's table in -> d: the output arrays, or (flags) shared memory
template <bool FLAGS>
__device__ __forceinline__ void copy_table(const Table& d, const TrackerArgs& a,
                                           long long base, int CL) {
  if (FLAGS) {
    load_flags(d.v, a.v_in + base, a.c_in + base, CL);
  } else {
    block_copy(d.v, a.v_in + base, CL);
    block_copy(d.cnt, a.c_in + base, CL);
  }
  block_copy(d.rst, a.rst_in + base, CL);
  block_copy(d.r1, a.r1_in + base, CL);
  block_copy(d.r2e, a.r2e_in + base, CL);
  block_copy(d.est, a.est_in + base, CL);
  block_copy(d.e1, a.e1_in + base, CL);
  block_copy(d.tot, a.tot_in + base, CL);
}

// EXPANDED = false: tracker_fold_compact; EXPANDED = true:
// tracker_fold_rows.  SHARED: the table lives in shared memory for the
// whole fold; else in the output arrays (device memory).
// Dynamic shared memory, in order: Partial [2][threads/32]; ren, mc, evt
// stage [threads] i32; (SHARED) rst, r1, r2e, est, e1, tot [CLp] i32 and
// the flags [CL16] u8; row_ok stage [threads] u8.  CLp = CL rounded up
// to 4, CL16 to 16 (fold_smem_bytes).
template <bool EXPANDED, bool SHARED>
__global__ void __launch_bounds__(1024)
    tracker_fold_kernel(const TrackerArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int CL = a.CL;
  const long long base = (long long)b * CL;

  Partial* parts = reinterpret_cast<Partial*>(smem);
  int32_t* s_ren = reinterpret_cast<int32_t*>(parts + 2 * (nt >> 5));
  int32_t* s_mc = s_ren + nt;
  int32_t* s_evt = s_mc + nt;
  unsigned char* tail = reinterpret_cast<unsigned char*>(s_evt + nt);
  Table out = {a.v + base, a.c + base, a.rst + base, a.r1 + base,
               a.r2e + base, a.est + base, a.e1 + base, a.tot + base};
  Table t = out;
  if (SHARED) {
    const int CLp = (CL + 3) & ~3, CL16 = (CL + 15) & ~15;
    t.rst = reinterpret_cast<int32_t*>(tail);
    t.r1 = t.rst + CLp;
    t.r2e = t.r1 + CLp;
    t.est = t.r2e + CLp;
    t.e1 = t.est + CLp;
    t.tot = t.e1 + CLp;
    t.v = reinterpret_cast<uint8_t*>(t.tot + CLp);
    t.cnt = nullptr;
    tail = t.v + CL16;
  }
  uint8_t* s_ok = tail;

  Scalars sc;
  sc.ls = a.ls_in[b];
  sc.ncl = a.ncl_in[b];
  sc.mml = a.mml_in[b];
  sc.mmrst = a.mmrst_in[b];
  sc.mmr1 = a.mmr1_in[b];
  sc.mmr2e = a.mmr2e_in[b];
  sc.mmest = a.mmest_in[b];
  sc.mme1 = a.mme1_in[b];
  sc.ovf = a.ovf_in[b];
  sc.ovfw = a.ovfw_in[b];

  int nrows;
  long long st;
  if (EXPANDED) {
    nrows = a.rows_r[b] < a.R ? a.rows_r[b] : a.R;
    st = (long long)b * a.R;
  } else {
    nrows = a.rows_eff[b];
    st = a.st_w[b];
  }

  if (nrows <= 0) {
    copy_table<false>(out, a, base, CL);  // nothing to fold
  } else if (SHARED) {
    copy_table<true>(t, a, base, CL);  // one load, then shared memory only
  } else {
    // each thread copies the clusters it owns: no barrier needed
    for (int c = tid; c < CL; c += nt) {
      out.v[c] = a.v_in[base + c];
      out.cnt[c] = a.c_in[base + c];
      out.rst[c] = a.rst_in[base + c];
      out.r1[c] = a.r1_in[base + c];
      out.r2e[c] = a.r2e_in[base + c];
      out.est[c] = a.est_in[base + c];
      out.e1[c] = a.e1_in[base + c];
      out.tot[c] = a.tot_in[base + c];
    }
  }

  int par = 0;
  for (int c0 = 0; c0 < nrows; c0 += nt) {
    // stage the next `nt` rows (one a thread) ahead of their chain
    if (c0 > 0) __syncthreads();
    const int r = c0 + tid;
    if (r < nrows) {
      long long gi = st + r;
      if (EXPANDED) {
        s_ok[tid] = a.row_ok[gi];
      } else {
        gi = gi < 0 ? 0 : (gi > a.RT - 1 ? a.RT - 1 : gi);
      }
      s_ren[tid] = a.ren[gi];
      s_mc[tid] = a.mc[gi];
      s_evt[tid] = a.evt[gi];
    }
    __syncthreads();
    const int n = nrows - c0 < nt ? nrows - c0 : nt;
    for (int i = 0; i < n; ++i) {
      if (EXPANDED && !s_ok[i]) {
        // a gated-off row changes nothing; _tracker_add still maps
        // len_sum to ((x + 0) + 0) - 0 (block-uniform)
        sc.ls = __fsub_rn(__fadd_rn(__fadd_rn(sc.ls, 0.0f), 0.0f), 0.0f);
        continue;
      }
      fold_row<SHARED>(t, sc, CL, a.min_aln_len, s_ren[i], s_mc[i],
                       s_evt[i], parts + par * (nt >> 5));
      par ^= 1;
    }
  }

  if (SHARED && nrows > 0) {
    __syncthreads();
    store_flags(out.v, out.cnt, t.v, CL);
    block_copy(out.rst, t.rst, CL);
    block_copy(out.r1, t.r1, CL);
    block_copy(out.r2e, t.r2e, CL);
    block_copy(out.est, t.est, CL);
    block_copy(out.e1, t.e1, CL);
    block_copy(out.tot, t.tot, CL);
  }
  if (tid == 0) {
    a.ls[b] = sc.ls;
    a.ncl[b] = sc.ncl;
    a.mml[b] = sc.mml;
    a.mmrst[b] = sc.mmrst;
    a.mmr1[b] = sc.mmr1;
    a.mmr2e[b] = sc.mmr2e;
    a.mmest[b] = sc.mmest;
    a.mme1[b] = sc.mme1;
    a.ovf[b] = (uint8_t)(sc.ovf != 0);
    a.ovfw[b] = sc.ovfw;
  }
}

// pointer array p: 8 tables + 10 scalars in, the same 18 out, then the
// row streams (see the two launchers)
static void unpack_state(void** p, TrackerArgs& a) {
  a.v_in = (const uint8_t*)p[0];
  a.c_in = (const uint8_t*)p[1];
  a.rst_in = (const int32_t*)p[2];
  a.r1_in = (const int32_t*)p[3];
  a.r2e_in = (const int32_t*)p[4];
  a.est_in = (const int32_t*)p[5];
  a.e1_in = (const int32_t*)p[6];
  a.tot_in = (const int32_t*)p[7];
  a.ls_in = (const float*)p[8];
  a.ncl_in = (const int32_t*)p[9];
  a.mml_in = (const int32_t*)p[10];
  a.mmrst_in = (const int32_t*)p[11];
  a.mmr1_in = (const int32_t*)p[12];
  a.mmr2e_in = (const int32_t*)p[13];
  a.mmest_in = (const int32_t*)p[14];
  a.mme1_in = (const int32_t*)p[15];
  a.ovf_in = (const uint8_t*)p[16];
  a.ovfw_in = (const int32_t*)p[17];
  a.v = (uint8_t*)p[18];
  a.c = (uint8_t*)p[19];
  a.rst = (int32_t*)p[20];
  a.r1 = (int32_t*)p[21];
  a.r2e = (int32_t*)p[22];
  a.est = (int32_t*)p[23];
  a.e1 = (int32_t*)p[24];
  a.tot = (int32_t*)p[25];
  a.ls = (float*)p[26];
  a.ncl = (int32_t*)p[27];
  a.mml = (int32_t*)p[28];
  a.mmrst = (int32_t*)p[29];
  a.mmr1 = (int32_t*)p[30];
  a.mmr2e = (int32_t*)p[31];
  a.mmest = (int32_t*)p[32];
  a.mme1 = (int32_t*)p[33];
  a.ovf = (uint8_t*)p[34];
  a.ovfw = (int32_t*)p[35];
}

// the kernel's dynamic shared memory (ops/tracker_kernel.py
// fold_smem_bytes computes the same)
static size_t fold_smem_bytes(int CL, int threads, int shared) {
  size_t n = 2 * (size_t)(threads / 32) * sizeof(Partial) +
             (size_t)threads * 13;
  if (shared) n += 24 * (size_t)((CL + 3) & ~3) + (size_t)((CL + 15) & ~15);
  return n;
}

// threads, shared and smem come from ops/tracker_kernel.py fold_launch;
// they are checked here against the kernel's layout
template <bool EXPANDED>
static int launch_fold(const TrackerArgs& a, int threads, int shared,
                       int smem, void* stream) {
  if (threads < 32 || threads > 1024 || (threads & (threads - 1)) ||
      a.CL < 1 || (size_t)smem != fold_smem_bytes(a.CL, threads, shared))
    return (int)cudaErrorInvalidValue;
  void (*k)(const TrackerArgs) = shared
                                     ? tracker_fold_kernel<EXPANDED, true>
                                     : tracker_fold_kernel<EXPANDED, false>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  k<<<a.B, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// p[36..40]: ren, mc, evt [RT] i32, st_w, rows_eff [B] i32
extern "C" int tracker_fold_compact(void** p, int B, int CL, int RT,
                                    int min_aln_len, int threads, int shared,
                                    int smem, void* stream) {
  if (B == 0) return 0;
  TrackerArgs a = {};
  unpack_state(p, a);
  a.ren = (const int32_t*)p[36];
  a.mc = (const int32_t*)p[37];
  a.evt = (const int32_t*)p[38];
  a.st_w = (const int32_t*)p[39];
  a.rows_eff = (const int32_t*)p[40];
  a.B = B;
  a.CL = CL;
  a.RT = RT;
  a.min_aln_len = min_aln_len;
  return launch_fold<false>(a, threads, shared, smem, stream);
}

// p[36..40]: ren, mc, evt [B, R] i32, row_ok [B, R] u8, rows_r [B] i32
extern "C" int tracker_fold_rows(void** p, int B, int CL, int R,
                                 int min_aln_len, int threads, int shared,
                                 int smem, void* stream) {
  if (B == 0) return 0;
  TrackerArgs a = {};
  unpack_state(p, a);
  a.ren = (const int32_t*)p[36];
  a.mc = (const int32_t*)p[37];
  a.evt = (const int32_t*)p[38];
  a.row_ok = (const uint8_t*)p[39];
  a.rows_r = (const int32_t*)p[40];
  a.B = B;
  a.CL = CL;
  a.R = R;
  a.min_aln_len = min_aln_len;
  return launch_fold<true>(a, threads, shared, smem, stream);
}
