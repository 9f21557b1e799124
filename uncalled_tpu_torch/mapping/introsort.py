"""Exact replica of libstdc++'s std::sort (introsort), for tie parity.

A build of the reference mapper with libstdc++'s std::sort as its
candidate sort (g++/libstdc++ 12) orders the candidate paths of each event
with this algorithm.  The comparator (mapper.cpp:866-871) keys on
(fm_start, fm_end, seed_prob) only, so the relative order of FULLY TIED
candidates is whatever introsort's partition history leaves -- and that
order is OBSERVABLE: duplicate-range dedup keeps the LAST of an equal run
(mapper.cpp:568-571), and the survivor's length/moves/consec history flows
into future events and seed reports.

An unstable sort's tie permutation can't be modeled by any per-element
key; the only exact model is the algorithm itself.  This module replicates
/usr/include/c++/12/bits/stl_algo.h (__sort, __introsort_loop,
__unguarded_partition_pivot, __move_median_to_first, __final_insertion_sort)
and stl_heap.h (__make_heap, __adjust_heap, __push_heap, __pop_heap,
__sort_heap, __heap_select) line for line.  It is pure Python on purpose:
its value is that it reproduces one binary's tie permutation, so it is
kept exactly as the algorithm runs, not made faster
(tests/test_torch_introsort.py holds it to the g++ probe's permutations in
tests/fixtures/introsort_golden.json).

API: std_sort(items, key) sorts IN PLACE with comp(a, b) = key(a) < key(b)
(tuple lexicographic, matching the C++ comparator's short-circuit form).
"""

from __future__ import annotations

_THRESHOLD = 16  # stl_algo.h _S_threshold


def std_sort(a: list, key, _depth_limit=None) -> list:
    """In-place libstdc++-exact unstable sort; returns a for convenience.

    _depth_limit overrides the __lg(n)*2 introsort depth (tests only: 0
    forces the heapsort fallback, the same code path as std::partial_sort).
    """
    n = len(a)
    if n < 2:
        return a
    k = [key(x) for x in a]

    def lt(i, j):  # __comp(it_i, it_j)
        return k[i] < k[j]

    def swap(i, j):
        a[i], a[j] = a[j], a[i]
        k[i], k[j] = k[j], k[i]

    # ---- stl_heap.h ----
    def push_heap(first, hole, top, val_a, val_k):
        parent = (hole - 1) // 2
        while hole > top and k[first + parent] < val_k:
            a[first + hole] = a[first + parent]
            k[first + hole] = k[first + parent]
            hole = parent
            parent = (hole - 1) // 2
        a[first + hole] = val_a
        k[first + hole] = val_k

    def adjust_heap(first, hole, length, val_a, val_k):
        top = hole
        second = hole
        while second < (length - 1) // 2:
            second = 2 * (second + 1)
            if k[first + second] < k[first + second - 1]:
                second -= 1
            a[first + hole] = a[first + second]
            k[first + hole] = k[first + second]
            hole = second
        if (length & 1) == 0 and second == (length - 2) // 2:
            second = 2 * (second + 1)
            a[first + hole] = a[first + second - 1]
            k[first + hole] = k[first + second - 1]
            hole = second - 1
        push_heap(first, hole, top, val_a, val_k)

    def pop_heap(first, last, result):
        val_a, val_k = a[result], k[result]
        a[result], k[result] = a[first], k[first]
        adjust_heap(first, 0, last - first, val_a, val_k)

    def make_heap(first, last):
        if last - first < 2:
            return
        length = last - first
        parent = (length - 2) // 2
        while True:
            val_a, val_k = a[first + parent], k[first + parent]
            adjust_heap(first, parent, length, val_a, val_k)
            if parent == 0:
                return
            parent -= 1

    def sort_heap(first, last):
        while last - first > 1:
            last -= 1
            pop_heap(first, last, last)

    def heap_select(first, middle, last):
        make_heap(first, middle)
        for i in range(middle, last):
            if lt(i, first):
                pop_heap(first, middle, i)

    # ---- stl_algo.h ----
    def unguarded_linear_insert(last):
        val_a, val_k = a[last], k[last]
        nxt = last - 1
        while val_k < k[nxt]:
            a[last], k[last] = a[nxt], k[nxt]
            last = nxt
            nxt -= 1
        a[last], k[last] = val_a, val_k

    def insertion_sort(first, last):
        if first == last:
            return
        for i in range(first + 1, last):
            if lt(i, first):
                val_a, val_k = a[i], k[i]
                a[first + 1 : i + 1] = a[first:i]
                k[first + 1 : i + 1] = k[first:i]
                a[first], k[first] = val_a, val_k
            else:
                unguarded_linear_insert(i)

    def unguarded_insertion_sort(first, last):
        for i in range(first, last):
            unguarded_linear_insert(i)

    def final_insertion_sort(first, last):
        if last - first > _THRESHOLD:
            insertion_sort(first, first + _THRESHOLD)
            unguarded_insertion_sort(first + _THRESHOLD, last)
        else:
            insertion_sort(first, last)

    def move_median_to_first(result, ai, bi, ci):
        if lt(ai, bi):
            if lt(bi, ci):
                swap(result, bi)
            elif lt(ai, ci):
                swap(result, ci)
            else:
                swap(result, ai)
        elif lt(ai, ci):
            swap(result, ai)
        elif lt(bi, ci):
            swap(result, ci)
        else:
            swap(result, bi)

    def unguarded_partition(first, last, pivot):
        while True:
            while lt(first, pivot):
                first += 1
            last -= 1
            while lt(pivot, last):
                last -= 1
            if not first < last:
                return first
            swap(first, last)
            first += 1

    def unguarded_partition_pivot(first, last):
        mid = first + (last - first) // 2
        move_median_to_first(first, first + 1, mid, last - 1)
        return unguarded_partition(first + 1, last, first)

    def introsort_loop(first, last, depth_limit):
        while last - first > _THRESHOLD:
            if depth_limit == 0:
                # __partial_sort(first, last, last)
                heap_select(first, last, last)
                sort_heap(first, last)
                return
            depth_limit -= 1
            cut = unguarded_partition_pivot(first, last)
            introsort_loop(cut, last, depth_limit)
            last = cut

    depth = (n.bit_length() - 1) * 2 if _depth_limit is None else _depth_limit
    introsort_loop(0, n, depth)  # __lg(n) * 2
    final_insertion_sort(0, n)
    return a
