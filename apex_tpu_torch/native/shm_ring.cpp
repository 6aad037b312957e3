// Shared-memory MPSC ring: the in-host actor->learner chunk plane.
//
// A copy of apex_tpu/native/shm_ring.cpp (the port imports nothing of
// apex_tpu and builds its own library).  The actor processes write frame
// chunks into a POSIX shared-memory segment: one memcpy in, one memcpy out,
// zero syscalls on the hot path, where multiprocessing.Queue pickles each
// chunk through an OS pipe and a feeder thread.  The bounded ring gives the
// same backpressure (a full ring blocks producers exactly like a full
// mp.Queue blocks put()).  This is host code, not a GPU kernel.
//
// Layout: a Header page, a cacheline-padded sequence word per slot, then
// n_slots fixed-size slots.  Coordination is the bounded-queue sequence
// scheme (Vyukov MPMC), used many-producer/one-consumer:
//
//   producer: t = tail; if seq[t % n] == t, CAS tail -> t+1 claims the
//             slot (already free); write payload; seq = t + 1 publishes.
//             seq < t means the ring is full -> wait WITHOUT claiming, so
//             a timeout simply returns and nothing is left half-claimed.
//   consumer: h = head (single consumer, plain variable); seq[h % n] ==
//             h + 1 means published; read; seq = h + n frees the slot for
//             ticket h + n.
//
// Waits spin briefly then sleep-poll (50us); chunk rates are O(10^2)
// messages/s, so poll latency is irrelevant — copy count is what matters.
//
// Crash notes: a producer killed between CAS-claim and publish (a
// microsecond window) leaves one slot unpublished, starving the consumer
// at that ticket — the same class of loss as killing a process inside
// mp.Queue.put (corrupted pipe).  The consumer recovers via
// apex_shm_force_skip after a long starvation window (see the function's
// contract below; ShmChunkQueue applies it automatically).
// ActorPool.cleanup drains with timeouts and destroys the segment, so
// shutdown never depends on ring liveness.  The creator unlinks any stale
// same-named segment left by a crashed run.
//
// Exposed as a plain-C ABI for ctypes, built with g++ at first use
// (apex_tpu_torch/native/__init__.py).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <sched.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x41504558534852ULL;  // "APEXSHR"

struct Header {
  uint64_t magic;
  uint64_t slot_size;   // bytes per slot, including the 8-byte length prefix
  uint64_t n_slots;
  alignas(64) std::atomic<uint64_t> tail;  // next producer ticket
  alignas(64) uint64_t head;               // consumer cursor (one consumer)
  alignas(64) std::atomic<uint64_t> dropped;  // push timeout returns
  // (backpressure events for blocking callers, NOT lost messages)
  alignas(64) std::atomic<uint64_t> disposed;  // tickets force-skipped away
  // from stalled producers (each is one undelivered message, resendable)
};

struct Seq {   // one per slot, padded: adjacent slots' producers don't
  alignas(64) std::atomic<uint64_t> v;      // false-share the sequence word
};

struct Ring {
  Header* hdr;
  Seq* seq;       // [n_slots]
  uint8_t* slots;
  size_t map_len;
  int owner;      // created (vs opened) — unlink on close
  char name[64];
};

inline void sleep_us(long us) {
  timespec ts{0, us * 1000L};
  nanosleep(&ts, nullptr);
}

inline double now_ms() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec * 1e3 + ts.tv_nsec / 1e6;
}

inline void backoff(int* spins) {
  if (++*spins < 64) sched_yield();
  else sleep_us(50);
}

Ring* map_ring(const char* name, int create, uint64_t slot_size,
               uint64_t n_slots) {
  int flags = create ? (O_CREAT | O_EXCL | O_RDWR) : O_RDWR;
  int fd = shm_open(name, flags, 0600);
  if (fd < 0) return nullptr;

  size_t len = 0;
  if (create) {
    len = sizeof(Header) + sizeof(Seq) * n_slots + slot_size * n_slots;
    if (ftruncate(fd, (off_t)len) != 0) {
      close(fd);
      shm_unlink(name);
      return nullptr;
    }
  } else {
    struct stat st;
    if (fstat(fd, &st) != 0 || (size_t)st.st_size < sizeof(Header)) {
      close(fd);
      return nullptr;
    }
    len = (size_t)st.st_size;
  }

  void* mem = mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);  // the mapping holds its own reference
  if (mem == MAP_FAILED) return nullptr;

  auto* hdr = (Header*)mem;
  auto* seq = (Seq*)((uint8_t*)mem + sizeof(Header));
  if (create) {
    hdr->magic = kMagic;
    hdr->slot_size = slot_size;
    hdr->n_slots = n_slots;
    hdr->tail.store(0, std::memory_order_relaxed);
    hdr->head = 0;
    hdr->dropped.store(0, std::memory_order_relaxed);
    hdr->disposed.store(0, std::memory_order_relaxed);
    for (uint64_t i = 0; i < n_slots; ++i)
      seq[i].v.store(i, std::memory_order_relaxed);
  } else if (hdr->magic != kMagic) {
    munmap(mem, len);
    return nullptr;
  }

  auto* r = new Ring;
  r->hdr = hdr;
  r->seq = seq;
  r->slots = (uint8_t*)mem + sizeof(Header) + sizeof(Seq) * hdr->n_slots;
  r->map_len = len;
  r->owner = create;
  strncpy(r->name, name, sizeof(r->name) - 1);
  r->name[sizeof(r->name) - 1] = '\0';
  return r;
}

}  // namespace

extern "C" {

void* apex_shm_create(const char* name, uint64_t slot_size,
                      uint64_t n_slots) {
  shm_unlink(name);  // stale segment from a crashed run
  return map_ring(name, 1, slot_size, n_slots);
}

void* apex_shm_open(const char* name) { return map_ring(name, 0, 0, 0); }

void apex_shm_close(void* handle) {
  if (!handle) return;
  auto* r = (Ring*)handle;
  if (r->owner) shm_unlink(r->name);
  munmap((void*)r->hdr, r->map_len);
  delete r;
}

// 0 = ok, -1 = timeout (ring full; nothing claimed), -2 = payload too
// large for a slot, -3 = ticket disposed by the consumer's force-skip
// while this producer was stalled (message NOT delivered; caller may
// simply push again under a fresh ticket).
int apex_shm_push(void* handle, const uint8_t* data, uint64_t len,
                  int timeout_ms) {
  auto* r = (Ring*)handle;
  Header* h = r->hdr;
  if (len + 8 > h->slot_size) return -2;

  double deadline = now_ms() + timeout_ms;
  int spins = 0;
  uint64_t t;
  for (;;) {
    t = h->tail.load(std::memory_order_relaxed);
    uint64_t s = t % h->n_slots;
    uint64_t sv = r->seq[s].v.load(std::memory_order_acquire);
    if (sv == t) {
      if (h->tail.compare_exchange_weak(t, t + 1,
                                        std::memory_order_relaxed))
        break;  // claimed a known-free slot
      // lost the race to another producer; retry immediately
    } else if (sv < t) {
      // ring full (slot not yet freed by the consumer): wait unclaimed
      if (timeout_ms >= 0 && now_ms() > deadline) {
        h->dropped.fetch_add(1, std::memory_order_relaxed);
        return -1;
      }
      backoff(&spins);
    }
    // sv > t: another producer published past us between the loads; retry
  }
  uint64_t s = t % h->n_slots;
  uint8_t* slot = r->slots + s * h->slot_size;
  memcpy(slot, &len, 8);
  memcpy(slot + 8, data, len);
  // Publish via CAS: if the consumer force-skipped this ticket while we
  // were stalled between claim and here, seq has already moved on — we
  // must NOT touch it (a blind store would deadlock the ring for every
  // later ticket on this slot).  The memcpy above may then have raced the
  // slot's next owner; the consumer tolerates that as one corrupt payload
  // (unpickle failure -> skipped), and we report -3 so the caller resends.
  uint64_t expect = t;
  if (!r->seq[s].v.compare_exchange_strong(expect, t + 1,
                                           std::memory_order_release,
                                           std::memory_order_relaxed)) {
    return -3;  // the skip itself was already counted in disposed
  }
  return 0;
}

// >=0 = payload length, -1 = timeout, -2 = out buffer too small,
// -3 = torn/corrupt length prefix (payload disposed, head advanced).
int64_t apex_shm_pop(void* handle, uint8_t* out, uint64_t cap,
                     int timeout_ms) {
  auto* r = (Ring*)handle;
  Header* h = r->hdr;
  uint64_t t = h->head;
  uint64_t s = t % h->n_slots;
  uint8_t* slot = r->slots + s * h->slot_size;

  double deadline = now_ms() + timeout_ms;
  int spins = 0;
  while (r->seq[s].v.load(std::memory_order_acquire) != t + 1) {
    if (timeout_ms >= 0 && now_ms() > deadline) return -1;
    backoff(&spins);
  }
  uint64_t len;
  memcpy(&len, slot, 8);
  if (len > h->slot_size - 8) {
    // Torn length prefix: a force-skipped producer's resurrected memcpy
    // raced this slot's reuse (see force-skip contract).  No valid push
    // can exceed slot_size - 8 (push rejects those with -2), so dispose
    // of the payload and keep the ring advancing instead of wedging.
    h->head = t + 1;
    r->seq[s].v.store(t + h->n_slots, std::memory_order_release);
    h->disposed.fetch_add(1, std::memory_order_relaxed);
    return -3;
  }
  if (len > cap) return -2;
  if (len) memcpy(out, slot + 8, len);
  h->head = t + 1;
  r->seq[s].v.store(t + h->n_slots, std::memory_order_release);
  return (int64_t)len;
}

uint64_t apex_shm_dropped(void* handle) {
  return ((Ring*)handle)->hdr->dropped.load(std::memory_order_relaxed);
}

uint64_t apex_shm_disposed(void* handle) {
  return ((Ring*)handle)->hdr->disposed.load(std::memory_order_relaxed);
}

// Consumer-side wedge recovery: if the head ticket was claimed (tail moved
// past it) but never published — its producer died (or stalled
// indefinitely) between CAS-claim and its publish — dispose of the ticket
// and free the slot in ONE CAS (t -> t + n_slots), advancing head past it.
// The CALLER supplies the liveness judgment (e.g. "pop has timed out for N
// seconds while pending() > 0").  If the claimant later resurrects, its
// own publish CAS fails cleanly (returns -3, see apex_shm_push); the only
// residual risk is its in-flight memcpy racing the slot's next owner —
// one corrupt payload, caught at unpickle, never a wedged ring.
// Returns 1 if skipped, 0 if the head is published/unclaimed.
int apex_shm_force_skip(void* handle) {
  auto* r = (Ring*)handle;
  Header* h = r->hdr;
  uint64_t t = h->head;
  if (h->tail.load(std::memory_order_relaxed) <= t) return 0;  // unclaimed
  uint64_t s = t % h->n_slots;
  uint64_t expect = t;  // claimed-but-unpublished state
  if (!r->seq[s].v.compare_exchange_strong(expect, t + h->n_slots,
                                           std::memory_order_release,
                                           std::memory_order_relaxed))
    return 0;           // published in the meantime: nothing to skip
  h->head = t + 1;
  h->disposed.fetch_add(1, std::memory_order_relaxed);
  return 1;
}

// TEST ONLY: claim the next ticket and never publish it — simulates a
// producer killed mid-write so force_skip paths can be exercised.
void apex_shm_test_claim(void* handle) {
  ((Ring*)handle)->hdr->tail.fetch_add(1, std::memory_order_relaxed);
}

// Messages published-or-claimed and not yet consumed (approximate).
uint64_t apex_shm_pending(void* handle) {
  auto* r = (Ring*)handle;
  uint64_t tail = r->hdr->tail.load(std::memory_order_relaxed);
  uint64_t head = r->hdr->head;
  return tail > head ? tail - head : 0;
}

uint64_t apex_shm_slot_size(void* handle) {
  return ((Ring*)handle)->hdr->slot_size;
}

}  // extern "C"
