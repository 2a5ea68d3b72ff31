// Clipped n-gram counting for corpus BLEU over int token ids, n = 1..4
// (the port's copy of the JAX package's clib/libbleu.cpp counter): hash-map
// counts of FNV-1a n-gram hashes, exposed through a C ABI for ctypes.
// scoring/bleu.py builds it with g++ on first use; ngram_stats there is the
// Python version it is held against.

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

}  // extern "C"
