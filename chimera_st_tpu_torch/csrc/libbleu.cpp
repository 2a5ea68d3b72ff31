// The port's copy of the JAX package's clib/libbleu.cpp, exposed through a
// C ABI for ctypes and built with g++ on first use (host_library.py):
// - chimera_bleu_add: clipped n-gram counting for corpus BLEU over int token
//   ids, n = 1..4, hash-map counts of FNV-1a n-gram hashes (scoring/bleu.py;
//   ngram_stats there is the Python version it is held against);
// - chimera_levenshtein: the edit distance of two int sequences
//   (scoring/wer.py; levenshtein_plain there);
// - chimera_batch_by_size_fast: token-budget batch packing
//   (data/batching.py; batch_by_size_plain there).

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct NGramKey {
  uint64_t h;
  bool operator==(const NGramKey& o) const { return h == o.h; }
};

struct NGramHash {
  size_t operator()(const NGramKey& k) const { return (size_t)k.h; }
};

inline uint64_t hash_ngram(const int32_t* toks, int n) {
  // FNV-1a over the token bytes
  uint64_t h = 1469598103934665603ULL;
  const uint8_t* p = reinterpret_cast<const uint8_t*>(toks);
  for (int i = 0; i < n * 4; ++i) {
    h ^= p[i];
    h *= 1099511628211ULL;
  }
  return h;
}

}  // namespace

extern "C" {

struct BleuStatC {
  int64_t reflen;
  int64_t predlen;
  int64_t match1, count1;
  int64_t match2, count2;
  int64_t match3, count3;
  int64_t match4, count4;
};

// Accumulate clipped n-gram stats for one (ref, pred) pair into *stat.
void chimera_bleu_add(BleuStatC* stat, const int32_t* ref, int64_t ref_len,
              const int32_t* pred, int64_t pred_len) {
  stat->reflen += ref_len;
  stat->predlen += pred_len;
  int64_t* matches = &stat->match1;
  for (int n = 1; n <= 4; ++n) {
    std::unordered_map<NGramKey, int32_t, NGramHash> rgrams;
    for (int64_t i = 0; i + n <= ref_len; ++i) {
      rgrams[{hash_ngram(ref + i, n)}]++;
    }
    int64_t match = 0;
    std::unordered_map<NGramKey, int32_t, NGramHash> used;
    for (int64_t i = 0; i + n <= pred_len; ++i) {
      NGramKey k{hash_ngram(pred + i, n)};
      auto it = rgrams.find(k);
      if (it != rgrams.end() && used[k] < it->second) {
        used[k]++;
        match++;
      }
    }
    int64_t count = pred_len - n + 1;
    matches[2 * (n - 1)] += match;
    matches[2 * (n - 1) + 1] += count > 0 ? count : 0;
  }
}

// Levenshtein distance between two int sequences (unit insertions,
// deletions and substitutions; two rows of the dynamic programme).
int64_t chimera_levenshtein(const int32_t* a, int64_t la, const int32_t* b, int64_t lb) {
  std::vector<int64_t> prev(lb + 1), cur(lb + 1);
  for (int64_t j = 0; j <= lb; ++j) prev[j] = j;
  for (int64_t i = 1; i <= la; ++i) {
    cur[0] = i;
    for (int64_t j = 1; j <= lb; ++j) {
      int64_t sub = prev[j - 1] + (a[i - 1] != b[j - 1] ? 1 : 0);
      int64_t del = prev[j] + 1;
      int64_t ins = cur[j - 1] + 1;
      int64_t m = sub < del ? sub : del;
      cur[j] = m < ins ? m : ins;
    }
    std::swap(prev, cur);
  }
  return prev[lb];
}

// Token-budget batch packing over sizes in walk order: a batch closes when
// one more item would hit max_sentences or push (n + 1) * max(size) over
// max_tokens; a closed batch keeps a multiple of bsz_mult (or, below it,
// its remainder) and carries the rest into the next. Writes the batches'
// END offsets into out_ends (room for n) and returns their number.
int64_t chimera_batch_by_size_fast(const int64_t* sizes, int64_t n, int64_t max_tokens,
                                   int64_t max_sentences, int64_t bsz_mult,
                                   int64_t* out_ends) {
  int64_t n_batches = 0;
  int64_t start = 0;
  int64_t sample_len = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t sz = sizes[i];
    sample_len = sample_len > sz ? sample_len : sz;
    int64_t cur = i - start;  // batch size before adding i
    int64_t num_tokens = (cur + 1) * sample_len;
    if (cur > 0 && (cur == max_sentences || num_tokens > max_tokens)) {
      int64_t mod_len = bsz_mult * (cur / bsz_mult);
      if (mod_len == 0) mod_len = cur % bsz_mult;
      out_ends[n_batches++] = start + mod_len;
      start = start + mod_len;
      // the longest of the carried tail and the current item
      sample_len = sz;
      for (int64_t j = start; j < i; ++j)
        sample_len = sample_len > sizes[j] ? sample_len : sizes[j];
    }
  }
  if (start < n) out_ends[n_batches++] = n;
  return n_batches;
}

}  // extern "C"
