// Native BPE merge core of the port's tokenizer: a copy of the reference's
// native/bpe_core.cc with the same C ABI (bpe_new, bpe_free, bpe_apply,
// bpe_apply_batch). The port builds it on first use with the host C++
// compiler (p2p_llm_chat_tpu_torch/utils/native.py:
// g++ -O2 -std=c++17 -shared -fPIC) into the git-ignored build directory;
// without a compiler the tokenizer takes its pure-Python merge path, whose
// output is identical.
//
// The greedy lowest-rank merge loop dominates encode() cost on long
// prompts (everything else in p2p_llm_chat_tpu_torch/tokenizer.py is regex
// and table lookups).
//
// Design: BPE runs in vocab-id space. Python precomputes, once per
// tokenizer, the pair table (left_id, right_id) -> (rank, merged_id); the
// per-call boundary is then just int32 arrays. The merge loop keeps a
// doubly-linked list over the symbol sequence and a binary heap of
// candidate merges keyed by (rank, position), giving O(n log n) per piece
// instead of the O(n^2) rescan of the pure-Python loop.

#include <cstdint>
#include <cstdlib>
#include <queue>
#include <unordered_map>
#include <vector>

namespace {

struct PairInfo {
  int32_t rank;
  int32_t merged;
};

using PairMap =
    std::unordered_map<uint64_t, PairInfo>;

inline uint64_t key(int32_t a, int32_t b) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(a)) << 32) |
         static_cast<uint32_t>(b);
}

struct Cand {
  int32_t rank;
  int32_t pos;        // left element index at push time
  int32_t left_id;    // snapshot for staleness check
  int32_t right_id;
  bool operator>(const Cand& o) const {
    return rank != o.rank ? rank > o.rank : pos > o.pos;
  }
};

}  // namespace

extern "C" {

// pair_keys[i] = (left_id << 32) | right_id; rank_merged[i] = (rank << 32)
// | merged_id. Returns an opaque handle.
void* bpe_new(const uint64_t* pair_keys, const uint64_t* rank_merged,
              int64_t n) {
  auto* m = new PairMap();
  m->reserve(static_cast<size_t>(n) * 2);
  for (int64_t i = 0; i < n; ++i) {
    PairInfo info{static_cast<int32_t>(rank_merged[i] >> 32),
                  static_cast<int32_t>(rank_merged[i] & 0xffffffffu)};
    m->emplace(pair_keys[i], info);
  }
  return m;
}

void bpe_free(void* h) { delete static_cast<PairMap*>(h); }

// Apply all merges to ids[0..n); write the result to out (capacity n).
// Returns the output length.
int32_t bpe_apply(void* h, const int32_t* ids, int32_t n, int32_t* out) {
  const PairMap& ranks = *static_cast<PairMap*>(h);
  if (n <= 1) {
    for (int32_t i = 0; i < n; ++i) out[i] = ids[i];
    return n;
  }

  std::vector<int32_t> sym(ids, ids + n);
  std::vector<int32_t> prev(n), next(n);
  std::vector<bool> alive(n, true);
  for (int32_t i = 0; i < n; ++i) {
    prev[i] = i - 1;
    next[i] = (i + 1 < n) ? i + 1 : -1;
  }

  std::priority_queue<Cand, std::vector<Cand>, std::greater<Cand>> heap;
  auto push = [&](int32_t i) {
    int32_t j = next[i];
    if (j < 0) return;
    auto it = ranks.find(key(sym[i], sym[j]));
    if (it != ranks.end())
      heap.push(Cand{it->second.rank, i, sym[i], sym[j]});
  };
  for (int32_t i = 0; i < n - 1; ++i) push(i);

  while (!heap.empty()) {
    Cand c = heap.top();
    heap.pop();
    int32_t i = c.pos;
    if (!alive[i]) continue;
    int32_t j = next[i];
    // Stale entries: either side merged since the push.
    if (j < 0 || sym[i] != c.left_id || sym[j] != c.right_id) continue;
    auto it = ranks.find(key(sym[i], sym[j]));
    if (it == ranks.end()) continue;

    sym[i] = it->second.merged;
    alive[j] = false;
    next[i] = next[j];
    if (next[j] >= 0) prev[next[j]] = i;
    if (prev[i] >= 0) push(prev[i]);
    push(i);
  }

  int32_t m = 0;
  for (int32_t i = 0; i >= 0; i = next[i])
    out[m++] = sym[i];
  return m;
}

// Batched variant — the actual serving entry point. One ctypes call per
// pre-tokenized chunk: ids is the concatenation of every piece's initial
// symbol ids, piece_lens[i] the length of piece i. Crossing the FFI once
// per chunk (not once per piece) is what makes native win: real prompts
// average a handful of symbols per piece, so per-call overhead dominates
// any per-piece boundary.
int64_t bpe_apply_batch(void* h, const int32_t* ids,
                        const int32_t* piece_lens, int32_t n_pieces,
                        int32_t* out) {
  int64_t in_off = 0, out_off = 0;
  for (int32_t p = 0; p < n_pieces; ++p) {
    out_off += bpe_apply(h, ids + in_off, piece_lens[p], out + out_off);
    in_off += piece_lens[p];
  }
  return out_off;
}

}  // extern "C"
