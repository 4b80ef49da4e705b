// jaxmc native host fingerprint store — phase 2 (VERDICT r4 #8).
//
// The device BFS keeps its seen-set in accelerator memory; for state spaces
// beyond HBM (SURVEY.md §7.5 "spill seen-set shards to host when full") the
// 128-bit state fingerprints spill into this store. Phase 1 was one sorted
// vector with a full O(|store|) rewrite per batch; phase 2 is an LSM-style
// tiered design built for seen-sets LARGER THAN RAM:
//
//   - immutable sorted RUNS held in mmap regions. Runs at or above a spill
//     threshold are FILE-backed (created in a spill dir, unlinked at once so
//     the space frees itself on process exit): the OS pages cold portions
//     out to disk, so the resident set stays bounded while membership
//     lookups touch only the O(log n) pages a galloping binary search hits.
//     Smaller runs use anonymous mmap.
//   - batch insert sorts + dedups the batch (first occurrence wins, exactly
//     the phase-1 contract), marks membership against every run with a
//     monotone galloping lower_bound (batch is sorted, so per-run probe
//     positions only move forward), and seals the new fingerprints as a
//     fresh run: O(batch x log|run| x runs) per level, never O(|store|).
//   - a BACKGROUND THREAD compacts when the run count exceeds a fan-in
//     bound: it k-way merges a snapshot of the current runs while inserts
//     keep landing as new runs on top; the run list swaps atomically under
//     a mutex when the merge finishes. Runs are immutable once sealed, so
//     the merger reads them without locks.
//
// C ABI only (bound via ctypes; pybind11 is not available in this image).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <unistd.h>

namespace {

struct Fp {
    uint64_t hi, lo;
    bool operator<(const Fp& o) const {
        return hi != o.hi ? hi < o.hi : lo < o.lo;
    }
    bool operator==(const Fp& o) const { return hi == o.hi && lo == o.lo; }
};

struct Run {
    Fp* data = nullptr;
    size_t n = 0;
    size_t map_bytes = 0;

    ~Run() {
        if (data && map_bytes) munmap(data, map_bytes);
    }
    Run(const Run&) = delete;
    Run& operator=(const Run&) = delete;
    Run() = default;
};

using RunPtr = std::shared_ptr<const Run>;

// mmap a writable region for n fingerprints; file-backed (immediately
// unlinked) when a spill dir is given and the run is large enough.
std::shared_ptr<Run> alloc_run(size_t n, const std::string& spill_dir,
                               uint64_t spill_threshold, int* seq) {
    auto run = std::make_shared<Run>();
    run->n = n;
    run->map_bytes = n * sizeof(Fp);
    if (run->map_bytes == 0) return run;
    if (!spill_dir.empty() && run->map_bytes >= spill_threshold) {
        char path[4096];
        std::snprintf(path, sizeof(path), "%s/jaxmc_fps_%d_%d.run",
                      spill_dir.c_str(), (int)getpid(), (*seq)++);
        int fd = open(path, O_RDWR | O_CREAT | O_EXCL, 0600);
        if (fd >= 0) {
            unlink(path);  // space frees itself when the mapping dies
            if (ftruncate(fd, (off_t)run->map_bytes) == 0) {
                void* p = mmap(nullptr, run->map_bytes,
                               PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
                close(fd);
                if (p != MAP_FAILED) {
                    run->data = static_cast<Fp*>(p);
                    return run;
                }
            } else {
                close(fd);
            }
        }
        // fall through to anonymous on any file failure
    }
    void* p = mmap(nullptr, run->map_bytes, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
    if (p == MAP_FAILED) {
        run->map_bytes = 0;
        run->n = 0;
        return run;  // callers treat n==0 as empty; insert will report 0
    }
    run->data = static_cast<Fp*>(p);
    return run;
}

// k-way merge of sorted-unique runs into a new sorted-unique run.
std::shared_ptr<Run> merge_runs(const std::vector<RunPtr>& src,
                                const std::string& spill_dir,
                                uint64_t spill_threshold, int* seq) {
    size_t total = 0;
    for (const auto& r : src) total += r->n;
    auto out = alloc_run(total, spill_dir, spill_threshold, seq);
    if (total == 0 || out->data == nullptr) return out;
    std::vector<size_t> pos(src.size(), 0);
    size_t m = 0;
    for (;;) {
        int best = -1;
        for (size_t i = 0; i < src.size(); ++i) {
            if (pos[i] < src[i]->n &&
                (best < 0 || src[i]->data[pos[i]] < src[best]->data[pos[best]]))
                best = (int)i;
        }
        if (best < 0) break;
        Fp f = src[best]->data[pos[best]++];
        if (m == 0 || !(out->data[m - 1] == f)) out->data[m++] = f;
    }
    out->n = m;  // runs hold disjoint sets, so m == total normally
    return out;
}

struct Store {
    std::string spill_dir;        // empty = anonymous mmap only
    uint64_t spill_threshold = 64ull << 20;  // bytes; runs >= this spill
    size_t max_runs = 8;          // compaction fan-in trigger

    std::mutex mu;                // guards runs + count + seq
    std::vector<RunPtr> runs;     // immutable sorted-unique runs
    uint64_t count = 0;
    int seq = 0;

    std::thread merger;
    std::atomic<bool> merging{false};

    ~Store() { join_merger(); }

    void join_merger() {
        if (merger.joinable()) merger.join();
    }

    std::vector<RunPtr> snapshot() {
        std::lock_guard<std::mutex> g(mu);
        return runs;
    }

    // kick a background compaction when the fan-in bound is exceeded;
    // at most one merge in flight (runs created meanwhile stack on top
    // and are picked up by the next compaction)
    void maybe_compact() {
        bool expected = false;
        {
            std::lock_guard<std::mutex> g(mu);
            if (runs.size() <= max_runs) return;
        }
        if (!merging.compare_exchange_strong(expected, true)) return;
        join_merger();  // reap the previous (finished) thread object
        std::vector<RunPtr> src = snapshot();
        merger = std::thread([this, src]() {
            int local_seq;
            {
                std::lock_guard<std::mutex> g(mu);
                local_seq = seq;
                seq += (int)src.size() + 1;
            }
            auto merged = merge_runs(src, spill_dir, spill_threshold,
                                     &local_seq);
            size_t total = 0;
            for (const auto& r : src) total += r->n;
            if (total > 0 && merged->data == nullptr) {
                // allocation failed mid-compaction: keep the source
                // runs untouched (a silent swap-to-empty would erase
                // the seen-set and re-expand visited states); the next
                // insert retries compaction when memory frees up
                merging.store(false);
                return;
            }
            {
                std::lock_guard<std::mutex> g(mu);
                std::vector<RunPtr> next;
                next.push_back(merged);
                // keep every run that arrived after the snapshot
                for (const auto& r : runs) {
                    bool in_src = false;
                    for (const auto& s : src)
                        if (s == r) { in_src = true; break; }
                    if (!in_src) next.push_back(r);
                }
                runs.swap(next);
            }
            merging.store(false);
        });
    }
};

}  // namespace

extern "C" {

void* jaxmc_fps_create_ex(const char* spill_dir,
                          uint64_t spill_threshold_bytes) {
    Store* st = new Store();
    if (spill_dir && spill_dir[0]) st->spill_dir = spill_dir;
    if (spill_threshold_bytes) st->spill_threshold = spill_threshold_bytes;
    return st;
}

void* jaxmc_fps_create() { return jaxmc_fps_create_ex(nullptr, 0); }

void jaxmc_fps_destroy(void* p) { delete static_cast<Store*>(p); }

uint64_t jaxmc_fps_count(void* p) {
    Store& st = *static_cast<Store*>(p);
    std::lock_guard<std::mutex> g(st.mu);
    return st.count;
}

// Marks out_new[i] = 1 for fingerprints absent from the store (first
// occurrence within the batch wins), inserts them, returns the number of
// new fingerprints. hi/lo/out_new are length n.
uint64_t jaxmc_fps_insert(void* p, const uint64_t* hi, const uint64_t* lo,
                          uint64_t n, uint8_t* out_new) {
    Store& st = *static_cast<Store*>(p);
    std::memset(out_new, 0, n);
    if (n == 0) return 0;

    std::vector<uint64_t> order(n);
    for (uint64_t i = 0; i < n; ++i) order[i] = i;
    std::sort(order.begin(), order.end(), [&](uint64_t a, uint64_t b) {
        Fp fa{hi[a], lo[a]}, fb{hi[b], lo[b]};
        if (fa == fb) return a < b;  // stable: first occurrence first
        return fa < fb;
    });

    // unique batch fingerprints in sorted order + their first batch index
    std::vector<Fp> uniq;
    std::vector<uint64_t> first_idx;
    uniq.reserve(n);
    first_idx.reserve(n);
    for (uint64_t k = 0; k < n; ++k) {
        uint64_t idx = order[k];
        Fp f{hi[idx], lo[idx]};
        if (!uniq.empty() && uniq.back() == f) continue;
        uniq.push_back(f);
        first_idx.push_back(idx);
    }

    // membership against every run: the batch is sorted, so each run is
    // probed with a forward-only galloping lower_bound
    std::vector<uint8_t> known(uniq.size(), 0);
    std::vector<RunPtr> runs = st.snapshot();
    for (const auto& run : runs) {
        const Fp* rd = run->data;
        size_t rpos = 0;
        for (size_t u = 0; u < uniq.size(); ++u) {
            if (known[u]) continue;
            const Fp* it = std::lower_bound(rd + rpos, rd + run->n,
                                            uniq[u]);
            rpos = (size_t)(it - rd);
            if (rpos >= run->n) break;
            if (rd[rpos] == uniq[u]) known[u] = 1;
        }
    }

    uint64_t new_count = 0;
    for (size_t u = 0; u < uniq.size(); ++u)
        if (!known[u]) ++new_count;
    if (new_count == 0) return 0;

    std::shared_ptr<Run> fresh;
    {
        std::lock_guard<std::mutex> g(st.mu);
        fresh = alloc_run(new_count, st.spill_dir, st.spill_threshold,
                          &st.seq);
    }
    if (fresh->data == nullptr && new_count > 0)
        return ~0ull;  // allocation failed: LOUD error sentinel — a silent
                       // 0 would mark genuinely-new states as seen and
                       // under-approximate the search
    size_t m = 0;
    for (size_t u = 0; u < uniq.size(); ++u) {
        if (known[u]) continue;
        out_new[first_idx[u]] = 1;
        fresh->data[m++] = uniq[u];
    }
    {
        std::lock_guard<std::mutex> g(st.mu);
        st.runs.push_back(fresh);
        st.count += new_count;
    }
    st.maybe_compact();
    return new_count;
}

// Marks out_found[i] = 1 for fingerprints PRESENT in the store; a pure
// membership probe — nothing is inserted.  Unlike insert's out_new
// (first in-batch occurrence wins), EVERY occurrence of an in-store
// fingerprint is marked: callers read per-row verdicts (the device POR
// filter masks candidate rows individually).  Same probe machinery as
// insert: sort the batch, gallop a forward-only lower_bound per run.
void jaxmc_fps_contains(void* p, const uint64_t* hi, const uint64_t* lo,
                        uint64_t n, uint8_t* out_found) {
    Store& st = *static_cast<Store*>(p);
    std::memset(out_found, 0, n);
    if (n == 0) return;

    std::vector<uint64_t> order(n);
    for (uint64_t i = 0; i < n; ++i) order[i] = i;
    std::sort(order.begin(), order.end(), [&](uint64_t a, uint64_t b) {
        Fp fa{hi[a], lo[a]}, fb{hi[b], lo[b]};
        if (fa == fb) return a < b;
        return fa < fb;
    });

    std::vector<RunPtr> runs = st.snapshot();
    for (const auto& run : runs) {
        const Fp* rd = run->data;
        size_t rpos = 0;
        for (uint64_t k = 0; k < n; ++k) {
            uint64_t idx = order[k];
            if (out_found[idx]) continue;
            Fp f{hi[idx], lo[idx]};
            const Fp* it = std::lower_bound(rd + rpos, rd + run->n, f);
            rpos = (size_t)(it - rd);
            if (rpos >= run->n) break;
            if (rd[rpos] == f) out_found[idx] = 1;
        }
    }
}

// Copies the sorted store contents into hi/lo (each sized to count) —
// the checkpoint/resume serialization surface. Reuses merge_runs (the
// ONE k-way merge in this file) into a scratch anonymous run; an
// allocation failure leaves the output zeroed, which the python side's
// sorted-unique import check rejects loudly.
void jaxmc_fps_export(void* p, uint64_t* hi, uint64_t* lo) {
    Store& st = *static_cast<Store*>(p);
    st.join_merger();
    std::vector<RunPtr> runs = st.snapshot();
    int seq = 0;
    auto merged = merge_runs(runs, std::string(), 0, &seq);
    if (merged->data == nullptr) return;
    for (size_t i = 0; i < merged->n; ++i) {
        hi[i] = merged->data[i].hi;
        lo[i] = merged->data[i].lo;
    }
}

// Replaces the store contents with n fingerprints; input must be sorted
// and unique (the export format). Returns 1 on success, 0 when the
// ordering invariant does not hold (store left empty in that case).
uint64_t jaxmc_fps_import(void* p, const uint64_t* hi, const uint64_t* lo,
                          uint64_t n) {
    Store& st = *static_cast<Store*>(p);
    st.join_merger();
    std::lock_guard<std::mutex> g(st.mu);
    st.runs.clear();
    st.count = 0;
    auto run = alloc_run(n, st.spill_dir, st.spill_threshold, &st.seq);
    if (n > 0 && run->data == nullptr) return 0;
    for (uint64_t i = 0; i < n; ++i) {
        Fp f{hi[i], lo[i]};
        if (i > 0 && !(run->data[i - 1] < f)) {
            return 0;
        }
        run->data[i] = f;
    }
    if (n > 0) {
        st.runs.push_back(std::move(run));
        st.count = n;
    }
    return 1;
}

}  // extern "C"
