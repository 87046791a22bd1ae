"""libstdc++'s std::sort and std::unique, step for step.

The reference orders its triplexes with std::sort under comparators that
have large tie classes (and one that is not a strict weak ordering), so the
order it writes is a property of libstdc++'s introsort (bits/stl_algo.h,
bits/stl_heap.h), not of the data alone.  These functions make the same
comparisons and moves on a Python list, so they give the same permutation.
`less(a, b)` is the comparator; an index that would leave the list, which
the unguarded loops of libstdc++ never check, raises IndexError.
"""

from __future__ import annotations

_THRESHOLD = 16


def _at(v: list, i: int):
    if i < 0 or i >= len(v):
        raise IndexError(f"std::sort emulation left the range at {i}")
    return v[i]


def sort(v: list, less) -> None:
    """std::sort(v.begin(), v.end(), less), in place."""
    n = len(v)
    if n < 2:
        return
    _introsort_loop(v, 0, n, 2 * (n.bit_length() - 1), less)
    _final_insertion_sort(v, 0, n, less)


def _introsort_loop(v, first, last, depth, less) -> None:
    while last - first > _THRESHOLD:
        if depth == 0:
            _heap_sort(v, first, last, less)
            return
        depth -= 1
        cut = _partition_pivot(v, first, last, less)
        _introsort_loop(v, cut, last, depth, less)
        last = cut


def _partition_pivot(v, first, last, less) -> int:
    mid = first + (last - first) // 2
    _median_to_first(v, first, first + 1, mid, last - 1, less)
    return _unguarded_partition(v, first + 1, last, first, less)


def _median_to_first(v, result, a, b, c, less) -> None:
    if less(v[a], v[b]):
        if less(v[b], v[c]):
            v[result], v[b] = v[b], v[result]
        elif less(v[a], v[c]):
            v[result], v[c] = v[c], v[result]
        else:
            v[result], v[a] = v[a], v[result]
    elif less(v[a], v[c]):
        v[result], v[a] = v[a], v[result]
    elif less(v[b], v[c]):
        v[result], v[c] = v[c], v[result]
    else:
        v[result], v[b] = v[b], v[result]


def _unguarded_partition(v, first, last, pivot, less) -> int:
    while True:
        while less(_at(v, first), v[pivot]):
            first += 1
        last -= 1
        while less(v[pivot], _at(v, last)):
            last -= 1
        if not first < last:
            return first
        v[first], v[last] = v[last], v[first]
        first += 1


def _final_insertion_sort(v, first, last, less) -> None:
    if last - first > _THRESHOLD:
        _insertion_sort(v, first, first + _THRESHOLD, less)
        for i in range(first + _THRESHOLD, last):
            _unguarded_linear_insert(v, i, less)
    else:
        _insertion_sort(v, first, last, less)


def _insertion_sort(v, first, last, less) -> None:
    for i in range(first + 1, last):
        if less(v[i], v[first]):
            val = v[i]
            v[first + 1:i + 1] = v[first:i]
            v[first] = val
        else:
            _unguarded_linear_insert(v, i, less)


def _unguarded_linear_insert(v, last, less) -> None:
    val = v[last]
    nxt = last - 1
    while less(val, _at(v, nxt)):
        v[last] = v[nxt]
        last = nxt
        nxt -= 1
    v[last] = val


def _heap_sort(v, first, last, less) -> None:
    """std::__partial_sort(first, last, last): make_heap, then sort_heap."""
    n = last - first
    if n >= 2:
        parent = (n - 2) // 2
        while True:
            _adjust_heap(v, first, parent, n, v[first + parent], less)
            if parent == 0:
                break
            parent -= 1
    while last - first > 1:
        last -= 1
        val = v[last]
        v[last] = v[first]
        _adjust_heap(v, first, 0, last - first, val, less)


def _adjust_heap(v, first, hole, n, val, less) -> None:
    top = hole
    child = hole
    while child < (n - 1) // 2:
        child = 2 * (child + 1)
        if less(v[first + child], v[first + child - 1]):
            child -= 1
        v[first + hole] = v[first + child]
        hole = child
    if n % 2 == 0 and child == (n - 2) // 2:
        child = 2 * (child + 1)
        v[first + hole] = v[first + child - 1]
        hole = child - 1
    parent = (hole - 1) // 2
    while hole > top and less(v[first + parent], val):
        v[first + hole] = v[first + parent]
        hole = parent
        parent = (hole - 1) // 2
    v[first + hole] = val


def unique(v: list, same) -> None:
    """v.erase(std::unique(v.begin(), v.end(), same), v.end()), in
    place: drops each element that `same(kept, it)` calls a copy of the
    last element kept."""
    n = len(v)
    first = 0
    while first + 1 < n and not same(v[first], v[first + 1]):
        first += 1
    if first + 1 >= n:
        return
    dest = first
    for i in range(first + 2, n):
        if not same(v[dest], v[i]):
            dest += 1
            v[dest] = v[i]
    del v[dest + 1:]
