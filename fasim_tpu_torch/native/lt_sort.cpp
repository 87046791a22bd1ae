// Native ordering runtime.
//
// The reference pipeline's output row order depends on std::sort with
// comparators that have large tie classes (and one that is not even a
// strict weak ordering), so the exact permutation is a property of
// libstdc++'s introsort, not of the data.  Rather than guess that
// permutation from Python, this tiny library applies the same STL
// algorithms to index-tagged keys: sorting {keys, idx} with a comparator
// that ignores idx performs the identical comparison/swap sequence as the
// reference sorting its triplex structs, so the resulting idx order IS the
// reference's permutation.
//
// Comparators mirror fastsim.h:92-156 and
// Fasim-LongTarget.cpp:847-850.
//
// Build: g++ -O2 -fPIC -shared lt_sort.cpp -o _lt_sort.so   (see __init__.py)

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct Key {
    int32_t stari, endi, starj, endj;
    float score;
    int32_t idx;
};

// fastsim.h:97-116 (compMyTriplexMultiple)
bool comp_multiple(const Key& a, const Key& b) {
    if (a.stari == b.stari) {
        if (a.starj == b.starj) return a.score > b.score;
        return a.starj > b.starj;
    }
    return a.starj > b.starj;
}

// fastsim.h:118-137 (compMyTriplexMultiple2)
bool comp_multiple2(const Key& a, const Key& b) {
    if (a.endi == b.endi) {
        if (a.starj == b.starj) return a.score > b.score;
        return a.starj < b.starj;
    }
    return a.starj < b.starj;
}

// fastsim.h:92-95 (compMyTriplexSingle)
bool comp_single(const Key& a, const Key& b) { return a.score > b.score; }

// fastsim.h:139-156 (sameMyTriplex): equal coordinates+score, or b contained
// in a with strictly lower score.
bool same_triplex(const Key& a, const Key& b) {
    if (a.stari == b.stari && a.starj == b.starj && a.endi == b.endi &&
        a.endj == b.endj && a.score == b.score)
        return true;
    if (b.stari >= a.stari && b.starj >= a.starj && b.endi <= a.endi &&
        b.endj <= a.endj && b.score < a.score)
        return true;
    return false;
}

struct MotifKey {
    int32_t motif;
    int32_t idx;
};

// Fasim-LongTarget.cpp:847-850 (comp)
bool comp_motif(const MotifKey& a, const MotifKey& b) {
    return a.motif < b.motif;
}

}  // namespace

extern "C" {

// fastSIM dedup chain (fastsim.h:273-283): sort(multiple), unique(same),
// sort(multiple2), unique(same), sort(single).  Returns the surviving count;
// out_idx[0..count) receives original indices in final order.
int32_t lt_fastsim_dedup(const int32_t* stari, const int32_t* endi,
                         const int32_t* starj, const int32_t* endj,
                         const float* score, int32_t n, int32_t* out_idx) {
    std::vector<Key> v(n);
    for (int32_t i = 0; i < n; i++)
        v[i] = Key{stari[i], endi[i], starj[i], endj[i], score[i], i};
    std::sort(v.begin(), v.end(), comp_multiple);
    v.erase(std::unique(v.begin(), v.end(), same_triplex), v.end());
    std::sort(v.begin(), v.end(), comp_multiple2);
    v.erase(std::unique(v.begin(), v.end(), same_triplex), v.end());
    std::sort(v.begin(), v.end(), comp_single);
    for (size_t i = 0; i < v.size(); i++) out_idx[i] = v[i].idx;
    return (int32_t)v.size();
}

// printResult's sort by cluster class (Fasim-LongTarget.cpp:813).
void lt_sort_by_motif(const int32_t* motif, int32_t n, int32_t* out_idx) {
    std::vector<MotifKey> v(n);
    for (int32_t i = 0; i < n; i++) v[i] = MotifKey{motif[i], i};
    std::sort(v.begin(), v.end(), comp_motif);
    for (int32_t i = 0; i < n; i++) out_idx[i] = v[i].idx;
}

}  // extern "C"
