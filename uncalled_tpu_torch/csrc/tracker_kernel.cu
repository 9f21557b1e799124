// Seed-tracker folds of the pooled and the classic step (Hopper, sm_90a).
//
// Two entries share one per-row update (fold_row):
//   tracker_fold_compact <- uncalled_tpu/ops/tracker_kernel.py:_kernel_c
//     (built by _build_c, called through tracker_run_compact from the
//     pooled step): read b's rows are rr_*[st_w[b] + r], r < rows_eff[b];
//   tracker_fold_rows    <- uncalled_tpu/ops/tracker_kernel.py:_kernel
//     (built by _build, called through tracker_run; the classic step's
//     row fold, engine.py:945-969): read b's rows are the [B, R] streams
//     at b*R + r, r < min(rows_r[b], R), each gated by row_ok (a gated-off
//     row only replays len_sum's ((x + 0) + 0) - 0).
// Each row folds into the read's [CL] cluster table:
// SeedTracker::add_seed (seed_tracker.cpp:157-232) with
// SeedCluster::update (:56-73).  Per row: the eligible cluster with the
// largest total wins (ties: largest r1, then largest evt_en, then first
// index); the reinsertion collision makes it a zombie; with no match the
// seed is inserted into a free slot or evicts the smallest cluster (ovf
// bit 1); len_sum is f32 in the reference's order
// ((len_sum + upd) + ins) - evicted; the best-cluster mm_* snapshot follows.
//
// Bound on the card: device memory and latency.  Each event the tables
// (8 fields x [B, CL]; 13.6 MB at B=256, CL=2048) are read once and
// written once; the fold itself is a serial chain of rows per read, each
// row a full scan of that read's table.  Design: one block per read (the
// TPU's sequential 8-read grid becomes B independent blocks, so any B
// works), the table stays in device memory (L2-resident at these sizes;
// the eject tiers' CL=16384/65536 tables work the same way), threads
// stride over CL and each row is ONE scan: a block reduction of the
// lexicographic match key, the evict key (min total, first index), a
// free-slot flag and a count of key collisions, after which thread 0
// applies the single-cluster update and the scalar updates.  Each read
// stops at its own row count: no batch maximum, no host sync.  Integer
// arithmetic wraps like JAX's int32 (done in unsigned); f32 is IEEE
// (never built with fast math).

#include <cuda_runtime.h>
#include <limits.h>
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

__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

struct Scan {
  int mtot, mr1, me1, midx;  // best eligible cluster; midx == INT_MAX: none
  int ekey, eidx;            // smallest evict key, first index
  int anyfree;               // some slot is unoccupied
  int ncoll;                 // # valid clusters whose key equals (r2, e2)
};

__device__ __forceinline__ bool match_better(int t, int r, int e, int i,
                                             const Scan& s) {
  if (i == INT_MAX) return false;
  if (s.midx == INT_MAX) return true;
  if (t != s.mtot) return t > s.mtot;
  if (r != s.mr1) return r > s.mr1;
  if (e != s.me1) return e > s.me1;
  return i < s.midx;
}

__device__ __forceinline__ void combine(Scan& s, const Scan& o) {
  if (match_better(o.mtot, o.mr1, o.me1, o.midx, s)) {
    s.mtot = o.mtot;
    s.mr1 = o.mr1;
    s.me1 = o.me1;
    s.midx = o.midx;
  }
  if (o.ekey < s.ekey || (o.ekey == s.ekey && o.eidx < s.eidx)) {
    s.ekey = o.ekey;
    s.eidx = o.eidx;
  }
  s.anyfree |= o.anyfree;
  s.ncoll += o.ncoll;
}

__device__ __forceinline__ Scan shfl_down(const Scan& s, int o) {
  Scan n;
  n.mtot = __shfl_down_sync(FULL_MASK, s.mtot, o);
  n.mr1 = __shfl_down_sync(FULL_MASK, s.mr1, o);
  n.me1 = __shfl_down_sync(FULL_MASK, s.me1, o);
  n.midx = __shfl_down_sync(FULL_MASK, s.midx, o);
  n.ekey = __shfl_down_sync(FULL_MASK, s.ekey, o);
  n.eidx = __shfl_down_sync(FULL_MASK, s.eidx, o);
  n.anyfree = __shfl_down_sync(FULL_MASK, s.anyfree, o);
  n.ncoll = __shfl_down_sync(FULL_MASK, s.ncoll, o);
  return n;
}

// One read's cluster table and tracker scalars inside its block.  The
// table lives in the output arrays; the scalars are thread 0's registers.
struct ReadFold {
  uint8_t* v;
  uint8_t* cnt;
  int32_t* rst;
  int32_t* r1;
  int32_t* r2e;
  int32_t* est;
  int32_t* e1;
  int32_t* tot;
  float ls;
  int ncl, mml, mmrst, mmr1, mmr2e, mmest, mme1, ovf, ovfw;
};

// Fold one seed row (ref_en, mcv, e2) into the read's table: one block-wide
// scan, then thread 0 applies the single-cluster update and the scalar
// updates.  Every thread of the block calls it (two barriers inside).
__device__ void fold_row(ReadFold& f, int CL, int min_aln_len, int ref_en,
                         int mcv, int e2, Scan* warp_scan) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int r2 = wadd(wsub(ref_en, mcv), 1);  // new.ref_en_start
  const int r2e = ref_en;                     // new.ref_en_end

  Scan s;
  s.mtot = NEG;
  s.mr1 = NEG;
  s.me1 = NEG;
  s.midx = INT_MAX;
  s.ekey = INT_MAX;
  s.eidx = INT_MAX;
  s.anyfree = 0;
  s.ncoll = 0;
  for (int c = tid; c < CL; c += nt) {
    const bool vb = f.v[c] != 0;
    const bool cb = f.cnt[c] != 0;
    const int r1c = f.r1[c], e1c = f.e1[c], totc = f.tot[c];
    const bool considered = vb && (r1c < r2 || (r1c == r2 && e1c <= e2));
    const int dr = wsub(r2, r1c);
    const int de = wsub(e2, e1c);
    // trunc vs floor of de/12 differs only at de < 0, where e1c <= e2
    // (the first conjunct) is already false
    const bool in_range = (e1c <= e2) && (dr <= de) && (dr >= de / 12);
    if (considered && in_range && match_better(totc, r1c, e1c, c, s)) {
      s.mtot = totc;
      s.mr1 = r1c;
      s.me1 = e1c;
      s.midx = c;
    }
    const int ek = cb ? totc : NEG;
    // strided c ascends: ties keep the first index
    if (s.eidx == INT_MAX || ek < s.ekey) {
      s.ekey = ek;
      s.eidx = c;
    }
    s.anyfree |= !cb;
    s.ncoll += (vb && r1c == r2 && e1c == e2) ? 1 : 0;
  }
  for (int o = 16; o > 0; o >>= 1) combine(s, shfl_down(s, o));
  if ((tid & 31) == 0) warp_scan[tid >> 5] = s;
  __syncthreads();

  if (tid == 0) {
    for (int w = 1; w < (nt + 31) / 32; ++w) combine(s, warp_scan[w]);
    if (s.midx != INT_MAX) {
      // SeedCluster::update on the matched cluster
      const int m = s.midx;
      const int a_r2e = f.r2e[m];
      const bool overlaps = r2 < a_r2e;
      const bool grows = r2e > a_r2e;
      const int growth = overlaps ? (grows ? wsub(r2e, a_r2e) : 0) : mcv;
      // the collision scan counted the matched cluster too when its
      // OLD key equals (r2, e2)
      const int self_coll = (f.r1[m] == r2 && f.e1[m] == e2) ? 1 : 0;
      const bool lost = (s.ncoll - self_coll) > 0;
      f.r1[m] = r2;
      if (grows || !overlaps) f.r2e[m] = r2e;
      f.e1[m] = e2;
      const int new_tot = wadd(f.tot[m], growth);
      f.tot[m] = new_tot;
      if (lost) f.v[m] = 0;
      f.ls = ((f.ls + (float)growth) + 0.0f) - 0.0f;
      f.ncl = wsub(f.ncl, lost ? 1 : 0);
      if (growth > 0 && new_tot >= min_aln_len && new_tot > f.mml) {
        f.mml = new_tot;
        f.mmrst = f.rst[m];
        f.mmr1 = f.r1[m];
        f.mmr2e = f.r2e[m];
        f.mmest = f.est[m];
        f.mme1 = f.e1[m];
      }
    } else {
      // insert into a free slot, else evict the smallest cluster
      const int m = s.eidx;
      const int evicted_len = f.cnt[m] ? f.tot[m] : 0;
      const int evicted_n = f.v[m] ? 1 : 0;
      if (!s.anyfree) {
        f.ovf = 1;
        f.ovfw |= 1;
      }
      f.v[m] = 1;
      f.cnt[m] = 1;
      f.r1[m] = r2;
      f.r2e[m] = r2e;
      f.rst[m] = r2;
      f.est[m] = e2;
      f.e1[m] = e2;
      f.tot[m] = mcv;
      f.ls = ((f.ls + 0.0f) + (float)mcv) - (float)evicted_len;
      f.ncl = wsub(wadd(f.ncl, 1), evicted_n);
      if (mcv >= min_aln_len && mcv > f.mml) {
        f.mml = mcv;
        f.mmrst = r2;
        f.mmr1 = r2;
        f.mmr2e = r2e;
        f.mmest = e2;
        f.mme1 = e2;
      }
    }
  }
  __syncthreads();
}

// EXPANDED = false: tracker_fold_compact, read b's rows are
//   ren/mc/evt[clamp(st_w[b] + r, 0, RT-1)], r < rows_eff[b];
// EXPANDED = true: tracker_fold_rows, read b's rows are
//   ren/mc/evt[b * R + r], r < min(rows_r[b], R), each gated by row_ok.
template <bool EXPANDED>
__global__ void tracker_fold_kernel(TrackerArgs a) {
  __shared__ Scan warp_scan[32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int CL = a.CL;
  const long long base = (long long)b * CL;

  ReadFold f;
  f.v = a.v + base;
  f.cnt = a.c + base;
  f.rst = a.rst + base;
  f.r1 = a.r1 + base;
  f.r2e = a.r2e + base;
  f.est = a.est + base;
  f.e1 = a.e1 + base;
  f.tot = a.tot + base;
  for (int c = tid; c < CL; c += nt) {
    f.v[c] = a.v_in[base + c];
    f.cnt[c] = a.c_in[base + c];
    f.rst[c] = a.rst_in[base + c];
    f.r1[c] = a.r1_in[base + c];
    f.r2e[c] = a.r2e_in[base + c];
    f.est[c] = a.est_in[base + c];
    f.e1[c] = a.e1_in[base + c];
    f.tot[c] = a.tot_in[base + c];
  }

  // per-read scalars (thread 0 owns them)
  f.ls = a.ls_in[b];
  f.ncl = a.ncl_in[b];
  f.mml = a.mml_in[b];
  f.mmrst = a.mmrst_in[b];
  f.mmr1 = a.mmr1_in[b];
  f.mmr2e = a.mmr2e_in[b];
  f.mmest = a.mmest_in[b];
  f.mme1 = a.mme1_in[b];
  f.ovf = a.ovf_in[b];
  f.ovfw = a.ovfw_in[b];

  int nrows;
  long long st;
  if (EXPANDED) {
    nrows = a.rows_r[b] < a.R ? a.rows_r[b] : a.R;
    st = (long long)b * a.R;
  } else {
    nrows = a.rows_eff[b];
    st = a.st_w[b];
  }
  __syncthreads();

  for (int r = 0; r < nrows; ++r) {
    long long gi = st + r;
    if (EXPANDED) {
      if (!a.row_ok[gi]) {
        // a gated-off row changes nothing; _tracker_add still maps
        // len_sum to ((x + 0) + 0) - 0 (row_ok is uniform in the block)
        if (tid == 0) f.ls = ((f.ls + 0.0f) + 0.0f) - 0.0f;
        continue;
      }
    } else {
      gi = gi < 0 ? 0 : (gi > a.RT - 1 ? a.RT - 1 : gi);
    }
    fold_row(f, CL, a.min_aln_len, a.ren[gi], a.mc[gi], a.evt[gi],
             warp_scan);
  }

  if (tid == 0) {
    a.ls[b] = f.ls;
    a.ncl[b] = f.ncl;
    a.mml[b] = f.mml;
    a.mmrst[b] = f.mmrst;
    a.mmr1[b] = f.mmr1;
    a.mmr2e[b] = f.mmr2e;
    a.mmest[b] = f.mmest;
    a.mme1[b] = f.mme1;
    a.ovf[b] = (uint8_t)(f.ovf != 0);
    a.ovfw[b] = f.ovfw;
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

static int threads_for(int CL) { return CL >= 8192 ? 1024 : 256; }

// p[36..40]: ren, mc, evt [RT] i32, st_w, rows_eff [B] i32
extern "C" int tracker_fold_compact(void** p, int B, int CL, int RT,
                                    int min_aln_len, void* stream) {
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
  tracker_fold_kernel<false>
      <<<B, threads_for(CL), 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// p[36..40]: ren, mc, evt [B, R] i32, row_ok [B, R] u8, rows_r [B] i32
extern "C" int tracker_fold_rows(void** p, int B, int CL, int R,
                                 int min_aln_len, void* stream) {
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
  tracker_fold_kernel<true>
      <<<B, threads_for(CL), 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
