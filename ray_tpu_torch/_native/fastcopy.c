/* Native data-plane helper for the shared-memory object store.
 *
 * The reference implements its object store data plane in C++ (plasma,
 * `src/ray/object_manager/plasma/`); this is the equivalent hot path for
 * this framework: gather-copy of serialized buffer parts into an shm
 * segment. Called through ctypes, so the GIL is released for the
 * duration — concurrent puts from different Python threads copy in
 * parallel, and a single large copy runs at memcpy speed instead of
 * Python's byte-wise memoryview assignment.
 *
 * A fresh tmpfs segment is *cold*: every 4 KiB page of the destination
 * triggers a fault + zero-page allocation on first touch, which caps a
 * naive memcpy near 0.4 GB/s. Two countermeasures:
 *   - MADV_POPULATE_WRITE batch-faults the range in one syscall
 *     (~1.5x alone);
 *   - the copy is split across worker threads — page faulting is
 *     per-page kernel work that scales across cores, as does memcpy
 *     bandwidth on multi-channel memory.
 *
 * Build: cc -O3 -shared -fPIC -pthread fastcopy.c -o fastcopy.so (done
 * lazily by ray_tpu_torch/_native/__init__.py; C99 + POSIX threads only).
 */

#define _GNU_SOURCE
#include <pthread.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>

#ifndef MADV_POPULATE_WRITE
#define MADV_POPULATE_WRITE 23 /* Linux 5.14+; madvise fails gracefully before */
#endif
#ifndef MADV_HUGEPAGE
#define MADV_HUGEPAGE 14
#endif

/* Best-effort page pre-fault of a destination range (tmpfs/anonymous).
 * Harmless when the kernel lacks MADV_POPULATE_WRITE or the range is not
 * madvise-able (e.g. not page-aligned: align inward first). */
void rtpu_prefault(char *dst, size_t len) {
    const size_t page = 4096;
    uintptr_t start = ((uintptr_t)dst + page - 1) & ~(page - 1);
    uintptr_t end = ((uintptr_t)dst + len) & ~(page - 1);
    if (end <= start)
        return;
    madvise((void *)start, end - start, MADV_HUGEPAGE);       /* THP if enabled */
    madvise((void *)start, end - start, MADV_POPULATE_WRITE); /* batch fault-in */
}

/* Copy n parts (srcs[i], lens[i]) into dst back to back. Returns total
 * bytes copied. Single-threaded variant (small copies / fallback). */
size_t rtpu_gather_copy(char *dst, const char **srcs, const size_t *lens,
                        int n) {
    size_t pos = 0;
    for (int i = 0; i < n; i++) {
        memcpy(dst + pos, srcs[i], lens[i]);
        pos += lens[i];
    }
    return pos;
}

/* Single copy with an explicit destination offset (chunked transfers). */
void rtpu_copy_at(char *dst, size_t offset, const char *src, size_t len) {
    if (len >= (1 << 21))
        rtpu_prefault(dst + offset, len);
    memcpy(dst + offset, src, len);
}

/* ------------------------------------------------------------------ */
/* Multithreaded gather copy                                           */
/* ------------------------------------------------------------------ */

typedef struct {
    char *dst;              /* destination base */
    const char **srcs;
    const size_t *lens;
    int n;                  /* number of parts */
    size_t begin, end;      /* byte range of the flattened stream to copy */
} copy_job;

static void *copy_worker(void *arg) {
    copy_job *job = (copy_job *)arg;
    size_t begin = job->begin, end = job->end;
    /* Fault this thread's slice in parallel with the other threads. */
    rtpu_prefault(job->dst + begin, end - begin);
    size_t pos = 0; /* running offset of the current part in the stream */
    for (int i = 0; i < job->n && pos < end; i++) {
        size_t len = job->lens[i];
        size_t part_end = pos + len;
        if (part_end > begin) {
            size_t from = (begin > pos) ? begin - pos : 0;
            size_t to = (end < part_end) ? end - pos : len;
            memcpy(job->dst + pos + from, job->srcs[i] + from, to - from);
        }
        pos = part_end;
    }
    return NULL;
}

/* Parallel gather copy: split the flattened byte stream into `nthreads`
 * contiguous slices, one thread per slice (each also pre-faults its
 * slice). Returns total bytes copied. */
size_t rtpu_gather_copy_mt(char *dst, const char **srcs, const size_t *lens,
                           int n, int nthreads) {
    size_t total = 0;
    for (int i = 0; i < n; i++)
        total += lens[i];
    if (total == 0)
        return 0;
    if (nthreads < 2 || total < (1 << 21)) {
        rtpu_prefault(dst, total);
        return rtpu_gather_copy(dst, srcs, lens, n);
    }
    if (nthreads > 32)
        nthreads = 32;
    pthread_t threads[32];
    copy_job jobs[32];
    int created[32] = {0};
    size_t chunk = (total + nthreads - 1) / nthreads;
    /* Align slice boundaries to 4 KiB so two threads never fault the
     * same destination page. */
    chunk = (chunk + 4095) & ~(size_t)4095;
    size_t begin = 0;
    int njobs = 0;
    for (int t = 0; t < nthreads && begin < total; t++) {
        size_t end = begin + chunk;
        if (end > total)
            end = total;
        jobs[t] = (copy_job){dst, srcs, lens, n, begin, end};
        if (pthread_create(&threads[t], NULL, copy_worker, &jobs[t]) == 0)
            created[t] = 1;
        else /* thread creation failed: do this slice inline */
            copy_worker(&jobs[t]);
        njobs = t + 1;
        begin = end;
    }
    for (int t = 0; t < njobs; t++)
        if (created[t])
            pthread_join(threads[t], NULL);
    return total;
}
