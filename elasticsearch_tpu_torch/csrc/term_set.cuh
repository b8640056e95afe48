// Term-set membership shared by K16 (csrc/term_set_scan.cu) and K13's
// term_set leaf (csrc/span_program.cu).
//
// A batch's term sets arrive as ops/lexical.term_set_index makes them: the
// sorted union of the batch's term ids (`keys`, n of them) and, per key and
// 64-query group, a bit mask of the queries whose set holds it (`bits`,
// [n, groups] int64). A token is looked up once (a binary search over the
// keys), whatever the number of queries; the queries holding it are one
// 64-bit word.

#pragma once

#include <stdint.h>

// The index of `x` in the sorted keys[0 .. n), or -1.
__device__ __forceinline__ int term_set_find(const int32_t* keys, int n,
                                             int32_t x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo < n && keys[lo] == x ? lo : -1;
}

// The queries of group g whose set holds key number `idx` (idx >= 0).
__device__ __forceinline__ unsigned long long term_set_queries(
    const unsigned long long* bits, int groups, int idx, int g) {
  return bits[(long long)idx * groups + g];
}
