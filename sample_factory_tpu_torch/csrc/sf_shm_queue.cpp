// Shared-memory MPMC message queue with batched put/get.
//
// The port's own copy of `sample_factory_tpu/native/sf_shm_queue.cpp`: the equivalent of the
// reference's `faster-fifo` dependency
// (reference docs/06-architecture/message-passing.md:43-49): a POSIX
// shared-memory ring of length-prefixed byte messages guarded by a
// process-shared mutex + condvars, with get_many()/put_many() batching so one
// lock acquisition drains/publishes many control messages. Used as the
// worker<->runner signal channel of the host-env pipeline; bulk tensor data
// never flows through here (it lives in SharedMemory slabs, like the
// reference's share_memory_() tensors).
//
// Built at first use by `native/shm_queue.py` into `_build/sf_shm_queue_<hash>.so`:
// g++ -O2 -shared -fPIC -o <out> sf_shm_queue.cpp -lpthread -lrt

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct QueueHeader {
    pthread_mutex_t mutex;
    pthread_cond_t cond_nonempty;
    pthread_cond_t cond_nonfull;
    uint64_t capacity;   // bytes in the ring
    uint64_t head;       // read offset (absolute, monotonically increasing)
    uint64_t tail;       // write offset (absolute)
    uint64_t num_msgs;
    uint32_t magic;
    uint32_t closed;
};

constexpr uint32_t kMagic = 0x53465148;  // "SFQH"

struct Queue {
    QueueHeader* hdr;
    uint8_t* data;
    size_t map_size;
    char name[256];
    int owner;
};

inline uint64_t ring_used(const QueueHeader* h) { return h->tail - h->head; }
inline uint64_t ring_free(const QueueHeader* h) { return h->capacity - ring_used(h); }

void ring_write(Queue* q, uint64_t offset, const void* src, uint64_t n) {
    uint64_t pos = offset % q->hdr->capacity;
    uint64_t first = q->hdr->capacity - pos;
    if (n <= first) {
        memcpy(q->data + pos, src, n);
    } else {
        memcpy(q->data + pos, src, first);
        memcpy(q->data, static_cast<const uint8_t*>(src) + first, n - first);
    }
}

void ring_read(Queue* q, uint64_t offset, void* dst, uint64_t n) {
    uint64_t pos = offset % q->hdr->capacity;
    uint64_t first = q->hdr->capacity - pos;
    if (n <= first) {
        memcpy(dst, q->data + pos, n);
    } else {
        memcpy(dst, q->data + pos, first);
        memcpy(static_cast<uint8_t*>(dst) + first, q->data, n - first);
    }
}

void abs_deadline(double timeout_sec, timespec* ts) {
    clock_gettime(CLOCK_REALTIME, ts);
    time_t sec = static_cast<time_t>(timeout_sec);
    long nsec = static_cast<long>((timeout_sec - static_cast<double>(sec)) * 1e9);
    ts->tv_sec += sec;
    ts->tv_nsec += nsec;
    if (ts->tv_nsec >= 1000000000L) {
        ts->tv_sec += 1;
        ts->tv_nsec -= 1000000000L;
    }
}

}  // namespace

extern "C" {

// Returns an opaque handle or nullptr.
void* sfq_create(const char* name, uint64_t capacity_bytes) {
    size_t map_size = sizeof(QueueHeader) + capacity_bytes;
    shm_unlink(name);  // stale segment from a dead process
    int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
    if (fd < 0) return nullptr;
    if (ftruncate(fd, static_cast<off_t>(map_size)) != 0) {
        close(fd);
        shm_unlink(name);
        return nullptr;
    }
    void* mem = mmap(nullptr, map_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
    close(fd);
    if (mem == MAP_FAILED) {
        shm_unlink(name);
        return nullptr;
    }

    auto* hdr = static_cast<QueueHeader*>(mem);
    memset(hdr, 0, sizeof(QueueHeader));

    pthread_mutexattr_t mattr;
    pthread_mutexattr_init(&mattr);
    pthread_mutexattr_setpshared(&mattr, PTHREAD_PROCESS_SHARED);
    pthread_mutexattr_setrobust(&mattr, PTHREAD_MUTEX_ROBUST);
    pthread_mutex_init(&hdr->mutex, &mattr);

    pthread_condattr_t cattr;
    pthread_condattr_init(&cattr);
    pthread_condattr_setpshared(&cattr, PTHREAD_PROCESS_SHARED);
    pthread_cond_init(&hdr->cond_nonempty, &cattr);
    pthread_cond_init(&hdr->cond_nonfull, &cattr);

    hdr->capacity = capacity_bytes;
    hdr->magic = kMagic;

    auto* q = new Queue();
    q->hdr = hdr;
    q->data = static_cast<uint8_t*>(mem) + sizeof(QueueHeader);
    q->map_size = map_size;
    strncpy(q->name, name, sizeof(q->name) - 1);
    q->owner = 1;
    return q;
}

void* sfq_attach(const char* name) {
    int fd = shm_open(name, O_RDWR, 0600);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0) {
        close(fd);
        return nullptr;
    }
    void* mem = mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
    close(fd);
    if (mem == MAP_FAILED) return nullptr;
    auto* hdr = static_cast<QueueHeader*>(mem);
    if (hdr->magic != kMagic) {
        munmap(mem, static_cast<size_t>(st.st_size));
        return nullptr;
    }
    auto* q = new Queue();
    q->hdr = hdr;
    q->data = static_cast<uint8_t*>(mem) + sizeof(QueueHeader);
    q->map_size = static_cast<size_t>(st.st_size);
    strncpy(q->name, name, sizeof(q->name) - 1);
    q->owner = 0;
    return q;
}

static int lock_robust(QueueHeader* hdr) {
    int rc = pthread_mutex_lock(&hdr->mutex);
    if (rc == EOWNERDEAD) {
        // a worker died holding the lock; state is length-prefixed so the
        // reader can keep going — mark consistent and continue
        pthread_mutex_consistent(&hdr->mutex);
        rc = 0;
    }
    return rc;
}

// 0 = ok, 1 = timeout, 2 = message too large, 3 = queue closed, <0 = error
int sfq_put_many(void* handle, const uint8_t* data, const uint32_t* sizes, uint32_t num_msgs, double timeout_sec) {
    auto* q = static_cast<Queue*>(handle);
    QueueHeader* hdr = q->hdr;

    uint64_t total = 0;
    for (uint32_t i = 0; i < num_msgs; i++) total += sizes[i] + sizeof(uint32_t);
    if (total > hdr->capacity) return 2;

    timespec deadline;
    abs_deadline(timeout_sec, &deadline);

    if (lock_robust(hdr) != 0) return -1;
    while (ring_free(hdr) < total) {
        if (hdr->closed) {
            pthread_mutex_unlock(&hdr->mutex);
            return 3;
        }
        int rc = pthread_cond_timedwait(&hdr->cond_nonfull, &hdr->mutex, &deadline);
        if (rc == ETIMEDOUT) {
            pthread_mutex_unlock(&hdr->mutex);
            return 1;
        }
    }
    uint64_t offset = hdr->tail;
    const uint8_t* src = data;
    for (uint32_t i = 0; i < num_msgs; i++) {
        uint32_t sz = sizes[i];
        ring_write(q, offset, &sz, sizeof(uint32_t));
        offset += sizeof(uint32_t);
        ring_write(q, offset, src, sz);
        offset += sz;
        src += sz;
    }
    hdr->tail = offset;
    hdr->num_msgs += num_msgs;
    pthread_cond_broadcast(&hdr->cond_nonempty);
    pthread_mutex_unlock(&hdr->mutex);
    return 0;
}

int sfq_put(void* handle, const uint8_t* data, uint32_t size, double timeout_sec) {
    return sfq_put_many(handle, data, &size, 1, timeout_sec);
}

// Drain up to max_msgs messages (at least one unless timeout) in ONE lock
// acquisition. out_sizes must hold max_msgs entries; buf must hold buf_size
// bytes. Returns like sfq_put_many; *out_count = messages read.
int sfq_get_many(void* handle, uint8_t* buf, uint64_t buf_size, uint32_t max_msgs, uint32_t* out_sizes,
                 uint32_t* out_count, double timeout_sec) {
    auto* q = static_cast<Queue*>(handle);
    QueueHeader* hdr = q->hdr;
    *out_count = 0;

    timespec deadline;
    abs_deadline(timeout_sec, &deadline);

    if (lock_robust(hdr) != 0) return -1;
    while (hdr->num_msgs == 0) {
        if (hdr->closed) {
            pthread_mutex_unlock(&hdr->mutex);
            return 3;
        }
        int rc = pthread_cond_timedwait(&hdr->cond_nonempty, &hdr->mutex, &deadline);
        if (rc == ETIMEDOUT) {
            pthread_mutex_unlock(&hdr->mutex);
            return 1;
        }
    }

    uint64_t used_buf = 0;
    while (*out_count < max_msgs && hdr->num_msgs > 0) {
        uint32_t sz;
        ring_read(q, hdr->head, &sz, sizeof(uint32_t));
        if (used_buf + sz > buf_size) {
            if (*out_count == 0) {
                pthread_mutex_unlock(&hdr->mutex);
                return 2;  // single message larger than the caller's buffer
            }
            break;
        }
        ring_read(q, hdr->head + sizeof(uint32_t), buf + used_buf, sz);
        hdr->head += sizeof(uint32_t) + sz;
        out_sizes[*out_count] = sz;
        (*out_count)++;
        used_buf += sz;
        hdr->num_msgs--;
    }
    pthread_cond_broadcast(&hdr->cond_nonfull);
    pthread_mutex_unlock(&hdr->mutex);
    return 0;
}

uint64_t sfq_size(void* handle) {
    auto* q = static_cast<Queue*>(handle);
    return q->hdr->num_msgs;
}

void sfq_mark_closed(void* handle) {
    auto* q = static_cast<Queue*>(handle);
    lock_robust(q->hdr);
    q->hdr->closed = 1;
    pthread_cond_broadcast(&q->hdr->cond_nonempty);
    pthread_cond_broadcast(&q->hdr->cond_nonfull);
    pthread_mutex_unlock(&q->hdr->mutex);
}

void sfq_close(void* handle, int unlink) {
    auto* q = static_cast<Queue*>(handle);
    char name[256];
    strncpy(name, q->name, sizeof(name));
    munmap(reinterpret_cast<uint8_t*>(q->hdr), q->map_size);
    if (unlink) shm_unlink(name);
    delete q;
}

}  // extern "C"
