// The port's native host library: the collate work of the input pipeline
// that numpy does slowly (counterpart of native/oneprot_host.cc, the JAX
// package's, with the same three functions):
//
//   - batch character tokenization (ESM2: cls + table(bytes) + eos + pad)
//   - k nearest neighbours within a cutoff, for residue graphs
//   - greedy max- (or min-) Hamming-diversity MSA row selection
//
// Plain C entry points on caller-owned buffers, bound with ctypes by
// oneprot_tpu_torch/native/__init__.py, which builds this file with g++ at
// first use (-ffp-contract=off: the squared distances round as numpy's do).
// ctypes releases the GIL for the whole call, so loader threads run side by
// side. Each function returns 0, or 1 for arguments it refuses (nothing is
// written then).

#include <algorithm>
#include <cstdint>
#include <limits>
#include <utility>
#include <vector>

extern "C" {

// lut: 256 int32 entries, byte -> token id (unk where unmapped). seqs: the
// sequences' bytes back to back; offsets: n + 1 prefix offsets into seqs.
// out: [n, pad_to] int32. Row i: cls, the first min(max_len, pad_to) - 2
// bytes of sequence i through lut, eos, then pad_id. pad_to < 2 leaves no
// room for cls and eos: refused.
int tokenize_batch(const uint8_t* seqs, const int64_t* offsets, int32_t n, const int32_t* lut,
                   int32_t cls_id, int32_t eos_id, int32_t pad_id, int32_t max_len,
                   int32_t pad_to, int32_t* out) {
  if (pad_to < 2) return 1;
  const int64_t body_cap = std::max<int64_t>(std::min(max_len, pad_to) - 2, 0);
  for (int32_t i = 0; i < n; ++i) {
    int32_t* row = out + static_cast<int64_t>(i) * pad_to;
    const int64_t start = offsets[i];
    const int32_t body = static_cast<int32_t>(std::min(offsets[i + 1] - start, body_cap));
    row[0] = cls_id;
    for (int32_t j = 0; j < body; ++j) row[1 + j] = lut[seqs[start + j]];
    row[1 + body] = eos_id;
    for (int32_t j = 2 + body; j < pad_to; ++j) row[j] = pad_id;
  }
  return 0;
}

// coords: [n, 3] float32. For each residue, its k nearest other residues
// by squared distance, ties to the lower index, into idx_out [n, k]; mask_out
// [n, k] is 1 where that neighbour lies within `cutoff`. Rows past the n - 1
// other residues hold index 0 and mask 0.
int knn_neighbors(const float* coords, int32_t n, int32_t k, float cutoff, int32_t* idx_out,
                  uint8_t* mask_out) {
  if (n < 0 || k < 0) return 1;
  const float cutoff2 = cutoff * cutoff;
  const int32_t k_eff = std::min<int32_t>(k, std::max<int32_t>(n - 1, 0));
  std::vector<std::pair<float, int32_t>> cand;
  cand.reserve(n);
  for (int32_t i = 0; i < n; ++i) {
    cand.clear();
    const float xi = coords[3 * i], yi = coords[3 * i + 1], zi = coords[3 * i + 2];
    for (int32_t j = 0; j < n; ++j) {
      if (j == i) continue;
      const float dx = coords[3 * j] - xi;
      const float dy = coords[3 * j + 1] - yi;
      const float dz = coords[3 * j + 2] - zi;
      cand.emplace_back(dx * dx + dy * dy + dz * dz, j);
    }
    std::partial_sort(cand.begin(), cand.begin() + k_eff, cand.end());
    int32_t* idx = idx_out + static_cast<int64_t>(i) * k;
    uint8_t* mask = mask_out + static_cast<int64_t>(i) * k;
    for (int32_t s = 0; s < k; ++s) {
      idx[s] = s < k_eff ? cand[s].second : 0;
      mask[s] = s < k_eff && cand[s].first <= cutoff2 ? 1 : 0;
    }
  }
  return 0;
}

// msa: [rows, cols] bytes. Row 0, then num_seqs - 1 times the unpicked row
// whose mean Hamming distance (the share of differing columns) to the
// picked rows is largest (mode 1) or smallest (mode 0), the first such row
// on a tie; out_indices: the min(num_seqs, rows) picks in ascending order.
// With no columns every distance is NaN, and the first unpicked row is
// taken, as numpy's argmax and argmin take the first NaN.
int greedy_select(const uint8_t* msa, int32_t rows, int32_t cols, int32_t num_seqs, int32_t mode,
                  int32_t* out_indices) {
  if (num_seqs < 1 || rows < 1) return 1;
  if (num_seqs >= rows) {
    for (int32_t i = 0; i < rows; ++i) out_indices[i] = i;
    return 0;
  }
  std::vector<double> dist_sum(rows, 0.0);
  std::vector<uint8_t> selected(rows, 0);
  std::vector<int32_t> picks;
  picks.reserve(num_seqs);
  picks.push_back(0);
  selected[0] = 1;
  for (int32_t step = 1; step < num_seqs; ++step) {
    const uint8_t* last = msa + static_cast<int64_t>(picks.back()) * cols;
    for (int32_t r = 0; r < rows; ++r) {
      if (selected[r]) continue;
      const uint8_t* row = msa + static_cast<int64_t>(r) * cols;
      int32_t diff = 0;
      for (int32_t c = 0; c < cols; ++c) diff += row[c] != last[c];
      dist_sum[r] += static_cast<double>(diff) / cols;
    }
    int32_t best = -1;
    double best_val = mode ? -std::numeric_limits<double>::infinity()
                           : std::numeric_limits<double>::infinity();
    for (int32_t r = 0; r < rows; ++r) {
      if (selected[r]) continue;
      const double mean_dist = dist_sum[r] / picks.size();
      if ((mode && mean_dist > best_val) || (!mode && mean_dist < best_val)) {
        best_val = mean_dist;
        best = r;
      }
    }
    if (best < 0)  // every distance NaN
      for (int32_t r = 0; r < rows && best < 0; ++r)
        if (!selected[r]) best = r;
    picks.push_back(best);
    selected[best] = 1;
  }
  std::sort(picks.begin(), picks.end());
  for (int32_t i = 0; i < num_seqs; ++i) out_indices[i] = picks[i];
  return 0;
}

}  // extern "C"
