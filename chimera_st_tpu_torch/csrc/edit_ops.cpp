// Batched edit operations for the Levenshtein and insertion transformers'
// training targets (host code, plain C interface; fairseq libnat's
// suggested_ed2_path): insert and delete cost 1, substitute 2, and the
// backtrack prefers insert > delete > keep. Emits the targets as flat
// arrays:
//   ins_counts [B, Lx-1]: tokens to insert between kept x[i] and x[i+1]
//   ins_masks  [B, Ly]  : y positions that are insertions
//   del_labels [B, Lx]  : 1 = delete x[i]
// x and y are right- or mixed-padded with `pad` (pad tokens are skipped).
// Built with g++ by data/edit_ops.py; its numpy version there is the plain
// version this routine is held against.
#include <cstdint>
#include <vector>

extern "C" {

void chimera_suggested_edit_ops(const int32_t* xs, const int32_t* ys, int64_t B, int64_t Lx,
                                int64_t Ly, int32_t pad, int32_t* ins_counts,
                                uint8_t* ins_masks, uint8_t* del_labels) {
  std::vector<int32_t> x, y, ops, d;
  std::vector<int64_t> xpos;  // the column of each non-pad x token
  for (int64_t b = 0; b < B; ++b) {
    x.clear();
    y.clear();
    xpos.clear();
    for (int64_t i = 0; i < Lx; ++i)
      if (xs[b * Lx + i] != pad) {
        x.push_back(xs[b * Lx + i]);
        xpos.push_back(i);
      }
    for (int64_t j = 0; j < Ly; ++j)
      if (ys[b * Ly + j] != pad) y.push_back(ys[b * Ly + j]);
    const int64_t lx = (int64_t)x.size(), ly = (int64_t)y.size();
    int32_t* ic = ins_counts + b * (Lx > 1 ? Lx - 1 : 1);
    uint8_t* im = ins_masks + b * Ly;
    uint8_t* dl = del_labels + b * Lx;
    if (lx == 0) {  // everything is an insertion
      for (int64_t j = 0; j < ly; ++j) im[j] = 1;
      continue;
    }
    d.assign((lx + 1) * (ly + 1), 0);
    auto D = [&](int64_t i, int64_t j) -> int32_t& { return d[i * (ly + 1) + j]; };
    for (int64_t i = 0; i <= lx; ++i) D(i, 0) = (int32_t)i;
    for (int64_t j = 0; j <= ly; ++j) D(0, j) = (int32_t)j;
    for (int64_t i = 1; i <= lx; ++i)
      for (int64_t j = 1; j <= ly; ++j) {
        int32_t best = (D(i - 1, j) < D(i, j - 1) ? D(i - 1, j) : D(i, j - 1)) + 1;
        int32_t sub = D(i - 1, j - 1) + (x[i - 1] == y[j - 1] ? 0 : 2);
        D(i, j) = best < sub ? best : sub;
      }
    // backtrack, recorded reversed: 1 insert y, 2 delete x, 3 keep
    ops.clear();
    int64_t i = lx, j = ly;
    while (i > 0 || j > 0) {
      if (j > 0 && D(i, j - 1) < D(i, j)) {
        ops.push_back(1);
        --j;
      } else if (i > 0 && D(i - 1, j) < D(i, j)) {
        ops.push_back(2);
        --i;
      } else {
        ops.push_back(3);
        --i;
        --j;
      }
    }
    // replay forward: an insertion lands in the slot after the xcount-th x
    // token; only interior slots train the insertion head
    int64_t xcount = 0, ycount = 0;
    for (int64_t k = (int64_t)ops.size() - 1; k >= 0; --k) {
      if (ops[k] == 1) {
        if (xcount >= 1 && xcount <= lx - 1) {
          ic[xcount - 1] += 1;
          if (ycount < ly) im[ycount] = 1;
        }
        ++ycount;
      } else if (ops[k] == 2) {
        dl[xpos[xcount]] = 1;
        ++xcount;
      } else {
        ++xcount;
        ++ycount;
      }
    }
  }
}

}  // extern "C"
