// Native sequential/multithreaded HNSW builder.
//
// Host-side construction path of vss_tpu: builds the same flat
// structure-of-arrays graph the TPU wave builder produces (adj0 /
// upper_adj / upper_row, -1 padded), using the classic insertion
// algorithm (Malkov & Yashunin 2016): greedy descent, per-level beam with
// ef_construction, diversity select-neighbors heuristic with
// fill-from-pruned, back-link pruning on overflow. Multithreaded over
// insertions with per-node spinlocks plus a global entry lock — the same
// concurrency contract the reference's builder has, implemented fresh.
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).
//
// Levels are pre-sampled by the Python caller so that native and wave
// builds share one level distribution (vss_tpu.index.graph.sample_levels).

#include <atomic>
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

enum Metric : int32_t { L2SQ = 0, COSINE = 1, IP = 2 };

struct Ctx {
  const float* vectors;
  int64_t n;
  int32_t d;
  int32_t m, m0, efc, max_levels;
  Metric metric;
  const int32_t* levels;
  // adjacency: per node, level 0 list + upper lists
  std::vector<std::vector<int32_t>> adj0;
  std::vector<std::vector<std::vector<int32_t>>> upper;  // [node][lev-1]
  std::vector<std::unique_ptr<std::mutex>> locks;
  std::mutex entry_lock;
  int32_t entry = -1;
  int32_t max_level = -1;

  const float* vec(int64_t i) const { return vectors + i * d; }

  float dist(const float* a, const float* b) const {
    double dot = 0, na = 0, nb = 0;
    for (int32_t j = 0; j < d; ++j) {
      double x = a[j], y = b[j];
      dot += x * y;
      na += x * x;
      nb += y * y;
    }
    switch (metric) {
      case L2SQ:
        return static_cast<float>(std::max(na + nb - 2 * dot, 0.0));
      case COSINE: {
        double denom = std::sqrt(na * nb);
        if (denom <= 0) return (na == 0 && nb == 0) ? 0.0f : 1.0f;
        return static_cast<float>(1.0 - dot / denom);
      }
      case IP:
      default:
        return static_cast<float>(1.0 - dot);
    }
  }

  std::vector<int32_t>& neigh(int64_t node, int32_t lev) {
    return lev == 0 ? adj0[node] : upper[node][lev - 1];
  }
};

using DistId = std::pair<float, int32_t>;

// beam search on one level; returns candidates ascending by distance.
void search_layer(Ctx& ctx, const float* q, int32_t ep, int32_t ef,
                  int32_t lev, std::vector<uint32_t>& visited, uint32_t mark,
                  std::vector<DistId>& out) {
  std::priority_queue<DistId, std::vector<DistId>, std::greater<>> cand;
  std::priority_queue<DistId> best;  // max-heap of current ef best
  float d0 = ctx.dist(q, ctx.vec(ep));
  visited[ep] = mark;
  cand.emplace(d0, ep);
  best.emplace(d0, ep);
  while (!cand.empty()) {
    auto [dc, c] = cand.top();
    if (static_cast<int32_t>(best.size()) >= ef && dc > best.top().first) break;
    cand.pop();
    std::vector<int32_t> nb;
    {
      std::lock_guard<std::mutex> g(*ctx.locks[c]);
      nb = ctx.neigh(c, lev);
    }
    for (int32_t v : nb) {
      if (v < 0 || visited[v] == mark) continue;
      visited[v] = mark;
      float dv = ctx.dist(q, ctx.vec(v));
      if (static_cast<int32_t>(best.size()) < ef || dv < best.top().first) {
        cand.emplace(dv, v);
        best.emplace(dv, v);
        if (static_cast<int32_t>(best.size()) > ef) best.pop();
      }
    }
  }
  out.clear();
  out.resize(best.size());
  for (int64_t i = static_cast<int64_t>(best.size()) - 1; i >= 0; --i) {
    out[i] = best.top();
    best.pop();
  }
}

// diversity heuristic: keep c iff closer to q than to any kept; fill from
// pruned in distance order.
void select_neighbors(Ctx& ctx, const std::vector<DistId>& cand_sorted,
                      int32_t m, std::vector<int32_t>& out) {
  out.clear();
  std::vector<DistId> pruned;
  for (const auto& [dc, c] : cand_sorted) {
    if (static_cast<int32_t>(out.size()) >= m) break;
    bool ok = true;
    for (int32_t k : out) {
      if (ctx.dist(ctx.vec(c), ctx.vec(k)) < dc) {
        ok = false;
        break;
      }
    }
    if (ok)
      out.push_back(c);
    else
      pruned.emplace_back(dc, c);
  }
  for (const auto& [dp, p] : pruned) {
    if (static_cast<int32_t>(out.size()) >= m) break;
    out.push_back(p);
  }
}

void insert_one(Ctx& ctx, int64_t node, std::vector<uint32_t>& visited,
                uint32_t& mark) {
  int32_t level = ctx.levels[node];
  const float* q = ctx.vec(node);

  int32_t ep, maxl;
  {
    std::lock_guard<std::mutex> g(ctx.entry_lock);
    ep = ctx.entry;
    maxl = ctx.max_level;
    if (ep < 0) {
      ctx.entry = static_cast<int32_t>(node);
      ctx.max_level = level;
      return;
    }
  }
  float ep_d = ctx.dist(q, ctx.vec(ep));
  // greedy descent above the insertion level
  for (int32_t lev = maxl; lev > level; --lev) {
    bool improved = true;
    while (improved) {
      improved = false;
      std::vector<int32_t> nb;
      {
        std::lock_guard<std::mutex> g(*ctx.locks[ep]);
        nb = ctx.neigh(ep, lev);
      }
      for (int32_t v : nb) {
        if (v < 0) continue;
        float dv = ctx.dist(q, ctx.vec(v));
        if (dv < ep_d) {
          ep_d = dv;
          ep = v;
          improved = true;
        }
      }
    }
  }
  // per-level beam + connect
  std::vector<DistId> cand;
  std::vector<int32_t> chosen;
  for (int32_t lev = std::min(level, maxl); lev >= 0; --lev) {
    ++mark;
    search_layer(ctx, q, ep, ctx.efc, lev, visited, mark, cand);
    select_neighbors(ctx, cand, ctx.m, chosen);
    int32_t cap = lev == 0 ? ctx.m0 : ctx.m;
    {
      std::lock_guard<std::mutex> g(*ctx.locks[node]);
      ctx.neigh(node, lev) = chosen;
    }
    for (int32_t v : chosen) {
      std::lock_guard<std::mutex> g(*ctx.locks[v]);
      auto& lst = ctx.neigh(v, lev);
      lst.push_back(static_cast<int32_t>(node));
      if (static_cast<int32_t>(lst.size()) > cap) {
        std::vector<DistId> vc;
        vc.reserve(lst.size());
        const float* vv = ctx.vec(v);
        for (int32_t u : lst) vc.emplace_back(ctx.dist(vv, ctx.vec(u)), u);
        std::sort(vc.begin(), vc.end());
        std::vector<int32_t> kept;
        select_neighbors(ctx, vc, cap, kept);
        lst = kept;
      }
    }
    if (!cand.empty()) ep = cand.front().second;
  }
  if (level > maxl) {
    std::lock_guard<std::mutex> g(ctx.entry_lock);
    if (level > ctx.max_level) {
      ctx.max_level = level;
      ctx.entry = static_cast<int32_t>(node);
    }
  }
}

}  // namespace

extern "C" {

// Builds the graph; writes flat arrays. Returns 0 on success.
int vss_hnsw_build(const float* vectors, int64_t n, int32_t d, int32_t m,
                   int32_t m0, int32_t ef_construction, int32_t metric,
                   const int32_t* levels, int32_t max_levels, int32_t* adj0,
                   int32_t* upper_adj, int32_t* upper_row, int32_t* entry_out,
                   int32_t* max_level_out, int64_t* upper_used_out,
                   int32_t n_threads) {
  if (n <= 0) {
    *entry_out = -1;
    *max_level_out = -1;
    *upper_used_out = 0;
    return 0;
  }
  Ctx ctx;
  ctx.vectors = vectors;
  ctx.n = n;
  ctx.d = d;
  ctx.m = m;
  ctx.m0 = m0;
  ctx.efc = ef_construction;
  ctx.max_levels = max_levels;
  ctx.metric = static_cast<Metric>(metric);
  ctx.levels = levels;
  ctx.adj0.resize(n);
  ctx.upper.resize(n);
  ctx.locks.resize(n);
  for (int64_t i = 0; i < n; ++i) {
    ctx.locks[i] = std::make_unique<std::mutex>();
    if (levels[i] > 0) ctx.upper[i].resize(levels[i]);
  }

  if (n_threads <= 0)
    n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
  n_threads = std::max(1, std::min<int32_t>(n_threads, 64));

  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    std::vector<uint32_t> visited(n, 0);
    uint32_t mark = 0;
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) break;
      insert_one(ctx, i, visited, mark);
    }
  };
  std::vector<std::thread> threads;
  for (int32_t t = 1; t < n_threads; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();

  // pack results into the flat arrays
  std::fill(adj0, adj0 + n * m0, -1);
  std::fill(upper_row, upper_row + n * max_levels, -1);
  int64_t next_row = 0;
  for (int64_t i = 0; i < n; ++i) {
    const auto& l0 = ctx.adj0[i];
    for (size_t j = 0; j < l0.size() && j < static_cast<size_t>(m0); ++j)
      adj0[i * m0 + j] = l0[j];
    for (int32_t lev = 1; lev <= levels[i]; ++lev) {
      upper_row[i * max_levels + (lev - 1)] = static_cast<int32_t>(next_row);
      int32_t* dst = upper_adj + next_row * m;
      std::fill(dst, dst + m, -1);
      const auto& lu = ctx.upper[i][lev - 1];
      for (size_t j = 0; j < lu.size() && j < static_cast<size_t>(m); ++j)
        dst[j] = lu[j];
      ++next_row;
    }
  }
  *entry_out = ctx.entry;
  *max_level_out = ctx.max_level;
  *upper_used_out = next_row;
  return 0;
}

}  // extern "C"
