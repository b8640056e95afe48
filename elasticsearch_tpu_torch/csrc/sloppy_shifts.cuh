// The in-order sloppy search shared by K11 (csrc/sloppy_phrase.cu) and K14
// (csrc/span_near.cu): the reference's _sloppy_displacement
// (elasticsearch_tpu/ops/phrase.py) for the terms after the anchored ones.
//
// For the match anchored at start position p, term k sits at its SMALLEST
// shift s_k >= 0 with tok(p + delta[k] + s_k) == qt[k]; the shifts are
// summed, and the search gives up as soon as the sum leaves no room in
// `budget`. No term matches at or past the row's extent `ext`.

#pragma once

#include <stdint.h>

// The summed smallest shifts of terms first .. n_terms - 1 of the query
// whose term ids are qt[], or -1 when they do not fit in `budget`. `tok(x)`
// reads the row's token at position x (x < ext).
template <typename Tok>
__device__ __forceinline__ int sloppy_rest_shifts(const int32_t* qt,
                                                  int first, int n_terms,
                                                  const int32_t* delta,
                                                  int budget, int p, int ext,
                                                  const Tok& tok) {
  int total = 0;
  for (int k = first; k < n_terms; ++k) {
    const int32_t want = qt[k];
    const int at = p + delta[k];
    int s = 0;
    while (s <= budget - total && at + s < ext && tok(at + s) != want) ++s;
    if (s > budget - total || at + s >= ext) return -1;
    total += s;
  }
  return total;
}
