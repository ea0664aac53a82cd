// Shared-memory object store — the per-node data plane.
//
// Role-equivalent to the reference's plasma store (reference:
// src/ray/object_manager/plasma/store.h:55, object_lifecycle_manager.h,
// eviction_policy.h) but redesigned for the rebuild: instead of a store
// *server* process speaking a socket protocol with fd-passing
// (reference: plasma/fling.cc), every worker maps one named POSIX shm
// arena and operates on it directly through this library. Synchronization
// is a robust process-shared mutex in the arena header. This removes the
// socket round-trip from create/get entirely (the reference's hot path,
// store.h client protocol) while keeping the same semantics:
//   create -> seal -> get (zero-copy, pinned) -> release -> delete
//   LRU eviction of unpinned sealed objects when the arena is full
//   (reference: plasma/eviction_policy.h LRU policy).
//
// Layout:
//   [StoreHeader | ObjectEntry[slots] | data arena]
// Allocator: first-fit free list with block headers and coalescing
// (stand-in for the reference's dlmalloc-over-mmap, plasma/dlmalloc.cc).
// All intra-arena references are offsets, so mappings need not share a base
// address across processes.

#include <atomic>
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

constexpr uint64_t kMagic = 0x5254505553544f52ULL;  // "RTPUSTOR"
constexpr uint32_t kIdSize = 28;
constexpr uint64_t kAlign = 64;

enum ObjState : uint32_t {
  kEmpty = 0,
  kCreating = 1,
  kSealed = 2,
};

// Error codes (mirrored in the Python binding).
enum {
  RTPU_OK = 0,
  RTPU_ERR_EXISTS = -1,
  RTPU_ERR_FULL = -2,
  RTPU_ERR_NOT_FOUND = -3,
  RTPU_ERR_NOT_SEALED = -4,
  RTPU_ERR_TABLE_FULL = -5,
  RTPU_ERR_SYS = -6,
  RTPU_ERR_PINNED = -7,
};

struct ObjectEntry {
  uint8_t id[kIdSize];
  uint32_t state;
  uint32_t pin_count;
  uint64_t data_offset;  // from arena base
  uint64_t data_size;
  int64_t lru_prev;  // slot index, -1 = none; only valid when sealed+unpinned
  int64_t lru_next;
  uint64_t seq;       // monotonically bumped on (re)use for ABA safety
  uint32_t creator_pid;
  uint32_t flags;     // bit0: delete_pending
};

struct FreeBlock {
  uint64_t size;       // payload size including this header
  uint64_t next;       // offset of next free block from data base, 0 = none
};

struct StoreHeader {
  uint64_t magic;
  uint64_t total_size;
  uint64_t slots;
  uint64_t data_capacity;
  uint64_t data_base;   // offset of arena from segment start
  uint64_t free_head;   // offset into data region, kNoBlock = none
  uint64_t bytes_used;
  uint64_t num_objects;
  int64_t lru_head;     // eviction candidates, head = oldest
  int64_t lru_tail;
  uint64_t lru_clock;
  // stats
  uint64_t total_created;
  uint64_t total_evicted;
  uint64_t total_deleted;
  uint64_t eviction_bytes;
  pthread_mutex_t mutex;
};

constexpr uint64_t kNoBlock = ~0ULL;

struct Store {
  void* base;
  uint64_t mapped_size;
  StoreHeader* hdr;
  ObjectEntry* table;
  uint8_t* data;
};

inline uint64_t align_up(uint64_t v) { return (v + kAlign - 1) & ~(kAlign - 1); }

uint64_t hash_id(const uint8_t* id) {
  // FNV-1a over the 28-byte id.
  uint64_t h = 1469598103934665603ULL;
  for (uint32_t i = 0; i < kIdSize; i++) {
    h ^= id[i];
    h *= 1099511628211ULL;
  }
  return h;
}

void lock(Store* s) {
  int rc = pthread_mutex_lock(&s->hdr->mutex);
  if (rc == EOWNERDEAD) {
    // A process died holding the lock; state may be a torn create. Mark the
    // mutex consistent; torn kCreating entries are reaped lazily by delete.
    pthread_mutex_consistent(&s->hdr->mutex);
  }
}

void unlock(Store* s) { pthread_mutex_unlock(&s->hdr->mutex); }

// ---- free-list allocator (first fit, coalescing on free) ----

uint64_t arena_alloc(Store* s, uint64_t size) {
  size = align_up(size);
  StoreHeader* h = s->hdr;
  uint64_t prev = kNoBlock;
  uint64_t cur = h->free_head;
  while (cur != kNoBlock) {
    FreeBlock* blk = reinterpret_cast<FreeBlock*>(s->data + cur);
    if (blk->size >= size) {
      uint64_t remainder = blk->size - size;
      if (remainder >= sizeof(FreeBlock) + kAlign) {
        // split: tail remains free
        uint64_t tail_off = cur + size;
        FreeBlock* tail = reinterpret_cast<FreeBlock*>(s->data + tail_off);
        tail->size = remainder;
        tail->next = blk->next;
        if (prev == kNoBlock) h->free_head = tail_off;
        else reinterpret_cast<FreeBlock*>(s->data + prev)->next = tail_off;
        h->bytes_used += size;
        return cur;
      } else {
        if (prev == kNoBlock) h->free_head = blk->next;
        else reinterpret_cast<FreeBlock*>(s->data + prev)->next = blk->next;
        h->bytes_used += blk->size;
        return cur;
      }
    }
    prev = cur;
    cur = blk->next;
  }
  return kNoBlock;
}

void arena_free(Store* s, uint64_t offset, uint64_t size) {
  size = align_up(size);
  StoreHeader* h = s->hdr;
  // insert sorted by offset, coalesce with neighbors
  uint64_t prev = kNoBlock;
  uint64_t cur = h->free_head;
  while (cur != kNoBlock && cur < offset) {
    prev = cur;
    cur = reinterpret_cast<FreeBlock*>(s->data + cur)->next;
  }
  FreeBlock* blk = reinterpret_cast<FreeBlock*>(s->data + offset);
  blk->size = size;
  blk->next = cur;
  if (prev == kNoBlock) h->free_head = offset;
  else reinterpret_cast<FreeBlock*>(s->data + prev)->next = offset;
  h->bytes_used -= size;
  // coalesce forward
  if (cur != kNoBlock && offset + blk->size == cur) {
    FreeBlock* nxt = reinterpret_cast<FreeBlock*>(s->data + cur);
    blk->size += nxt->size;
    blk->next = nxt->next;
  }
  // coalesce backward
  if (prev != kNoBlock) {
    FreeBlock* pb = reinterpret_cast<FreeBlock*>(s->data + prev);
    if (prev + pb->size == offset) {
      pb->size += blk->size;
      pb->next = blk->next;
    }
  }
}

// ---- object table: open addressing, linear probe ----

int64_t table_find(Store* s, const uint8_t* id) {
  uint64_t slots = s->hdr->slots;
  uint64_t idx = hash_id(id) % slots;
  for (uint64_t i = 0; i < slots; i++) {
    ObjectEntry* e = &s->table[(idx + i) % slots];
    if (e->state == kEmpty) {
      // Deleted entries keep a tombstone flag so probes continue.
      if (!(e->flags & 2)) return -1;
      continue;
    }
    if (memcmp(e->id, id, kIdSize) == 0) return (int64_t)((idx + i) % slots);
  }
  return -1;
}

int64_t table_insert_slot(Store* s, const uint8_t* id) {
  uint64_t slots = s->hdr->slots;
  uint64_t idx = hash_id(id) % slots;
  for (uint64_t i = 0; i < slots; i++) {
    ObjectEntry* e = &s->table[(idx + i) % slots];
    if (e->state == kEmpty) return (int64_t)((idx + i) % slots);
  }
  return -1;
}

// ---- LRU list of evictable (sealed, unpinned) objects ----

void lru_push_back(Store* s, int64_t slot) {
  StoreHeader* h = s->hdr;
  ObjectEntry* e = &s->table[slot];
  e->lru_prev = h->lru_tail;
  e->lru_next = -1;
  if (h->lru_tail >= 0) s->table[h->lru_tail].lru_next = slot;
  h->lru_tail = slot;
  if (h->lru_head < 0) h->lru_head = slot;
}

void lru_remove(Store* s, int64_t slot) {
  StoreHeader* h = s->hdr;
  ObjectEntry* e = &s->table[slot];
  if (e->lru_prev >= 0) s->table[e->lru_prev].lru_next = e->lru_next;
  else if (h->lru_head == slot) h->lru_head = e->lru_next;
  if (e->lru_next >= 0) s->table[e->lru_next].lru_prev = e->lru_prev;
  else if (h->lru_tail == slot) h->lru_tail = e->lru_prev;
  e->lru_prev = e->lru_next = -1;
}

void delete_entry_locked(Store* s, int64_t slot) {
  ObjectEntry* e = &s->table[slot];
  if (e->state == kSealed && e->pin_count == 0) lru_remove(s, slot);
  if (e->data_size > 0) arena_free(s, e->data_offset, e->data_size);
  e->state = kEmpty;
  e->flags = 2;  // tombstone
  e->pin_count = 0;
  s->hdr->num_objects--;
  s->hdr->total_deleted++;
}

// Evict LRU objects until `needed` bytes could plausibly be allocated.
// Returns true if anything was evicted.
bool evict_for(Store* s, uint64_t needed) {
  StoreHeader* h = s->hdr;
  bool any = false;
  while (h->lru_head >= 0) {
    // free list may already satisfy after coalescing; try cheap check
    uint64_t off = arena_alloc(s, needed);
    if (off != kNoBlock) {
      arena_free(s, off, needed);
      return any;
    }
    int64_t victim = h->lru_head;
    ObjectEntry* e = &s->table[victim];
    h->total_evicted++;
    h->eviction_bytes += e->data_size;
    delete_entry_locked(s, victim);
    any = true;
  }
  return any;
}

}  // namespace

extern "C" {

// Returns mapped handle or nullptr. total size derived from capacity+slots.
void* rtpu_store_create(const char* name, uint64_t capacity, uint64_t slots) {
  uint64_t table_bytes = align_up(slots * sizeof(ObjectEntry));
  uint64_t header_bytes = align_up(sizeof(StoreHeader));
  uint64_t total = header_bytes + table_bytes + capacity;
  shm_unlink(name);
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (ftruncate(fd, (off_t)total) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* base = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  auto* hdr = reinterpret_cast<StoreHeader*>(base);
  memset(hdr, 0, sizeof(StoreHeader));
  hdr->total_size = total;
  hdr->slots = slots;
  hdr->data_capacity = capacity;
  hdr->data_base = header_bytes + table_bytes;
  hdr->lru_head = hdr->lru_tail = -1;

  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&hdr->mutex, &attr);
  pthread_mutexattr_destroy(&attr);

  auto* store = new Store();
  store->base = base;
  store->mapped_size = total;
  store->hdr = hdr;
  store->table = reinterpret_cast<ObjectEntry*>(
      reinterpret_cast<uint8_t*>(base) + header_bytes);
  memset(store->table, 0, slots * sizeof(ObjectEntry));
  store->data = reinterpret_cast<uint8_t*>(base) + hdr->data_base;

  // one big free block
  FreeBlock* blk = reinterpret_cast<FreeBlock*>(store->data);
  blk->size = capacity;
  blk->next = kNoBlock;
  hdr->free_head = 0;
  hdr->magic = kMagic;  // publish last
  return store;
}

void* rtpu_store_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                    MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  auto* hdr = reinterpret_cast<StoreHeader*>(base);
  if (hdr->magic != kMagic) {
    munmap(base, (size_t)st.st_size);
    return nullptr;
  }
  auto* store = new Store();
  store->base = base;
  store->mapped_size = (uint64_t)st.st_size;
  store->hdr = hdr;
  store->table = reinterpret_cast<ObjectEntry*>(
      reinterpret_cast<uint8_t*>(base) + align_up(sizeof(StoreHeader)));
  store->data = reinterpret_cast<uint8_t*>(base) + hdr->data_base;
  return store;
}

void rtpu_store_close(void* handle) {
  auto* s = reinterpret_cast<Store*>(handle);
  munmap(s->base, s->mapped_size);
  delete s;
}

int rtpu_store_unlink(const char* name) { return shm_unlink(name); }

// Create an object buffer for zero-copy writing. On success *out_ptr points
// at `size` writable bytes. Object is invisible to get() until sealed.
int rtpu_store_create_object(void* handle, const uint8_t* id, uint64_t size,
                             void** out_ptr) {
  auto* s = reinterpret_cast<Store*>(handle);
  lock(s);
  if (table_find(s, id) >= 0) {
    unlock(s);
    return RTPU_ERR_EXISTS;
  }
  uint64_t alloc_size = size ? size : kAlign;
  uint64_t off = arena_alloc(s, alloc_size);
  if (off == kNoBlock) {
    evict_for(s, alloc_size);
    off = arena_alloc(s, alloc_size);
  }
  if (off == kNoBlock) {
    unlock(s);
    return RTPU_ERR_FULL;
  }
  int64_t slot = table_insert_slot(s, id);
  if (slot < 0) {
    arena_free(s, off, alloc_size);
    unlock(s);
    return RTPU_ERR_TABLE_FULL;
  }
  ObjectEntry* e = &s->table[slot];
  memcpy(e->id, id, kIdSize);
  e->state = kCreating;
  e->pin_count = 1;  // creator holds a pin until seal+release
  e->data_offset = off;
  e->data_size = alloc_size;
  e->lru_prev = e->lru_next = -1;
  e->seq++;
  e->creator_pid = (uint32_t)getpid();
  e->flags = 0;
  s->hdr->num_objects++;
  s->hdr->total_created++;
  *out_ptr = s->data + off;
  unlock(s);
  return RTPU_OK;
}

// Seal: object becomes immutable and visible. Keeps the creator pin.
int rtpu_store_seal(void* handle, const uint8_t* id) {
  auto* s = reinterpret_cast<Store*>(handle);
  lock(s);
  int64_t slot = table_find(s, id);
  if (slot < 0) {
    unlock(s);
    return RTPU_ERR_NOT_FOUND;
  }
  ObjectEntry* e = &s->table[slot];
  if (e->state == kSealed) {
    unlock(s);
    return RTPU_OK;
  }
  e->state = kSealed;
  unlock(s);
  return RTPU_OK;
}

// Get a sealed object: pins it and returns a pointer + size. Zero-copy.
int rtpu_store_get(void* handle, const uint8_t* id, void** out_ptr,
                   uint64_t* out_size) {
  auto* s = reinterpret_cast<Store*>(handle);
  lock(s);
  int64_t slot = table_find(s, id);
  if (slot < 0) {
    unlock(s);
    return RTPU_ERR_NOT_FOUND;
  }
  ObjectEntry* e = &s->table[slot];
  if (e->state != kSealed) {
    unlock(s);
    return RTPU_ERR_NOT_SEALED;
  }
  if (e->pin_count == 0) lru_remove(s, slot);
  e->pin_count++;
  *out_ptr = s->data + e->data_offset;
  *out_size = e->data_size;
  unlock(s);
  return RTPU_OK;
}

// Release one pin. When the last pin drops the object becomes evictable
// (joins LRU) — or is deleted immediately if delete_pending. A release of
// an object with no pin (the owner's free after a secondary copy's own
// release) changes nothing: pushing the entry onto the LRU list a second
// time would link it to itself, and eviction would then spin on it.
int rtpu_store_release(void* handle, const uint8_t* id) {
  auto* s = reinterpret_cast<Store*>(handle);
  lock(s);
  int64_t slot = table_find(s, id);
  if (slot < 0) {
    unlock(s);
    return RTPU_ERR_NOT_FOUND;
  }
  ObjectEntry* e = &s->table[slot];
  if (e->pin_count == 0) {
    unlock(s);
    return RTPU_OK;
  }
  e->pin_count--;
  if (e->pin_count == 0) {
    if (e->flags & 1) {
      delete_entry_locked(s, slot);
    } else if (e->state == kSealed) {
      s->hdr->lru_clock++;
      lru_push_back(s, slot);
    } else {
      // creator died mid-create; reclaim
      delete_entry_locked(s, slot);
    }
  }
  unlock(s);
  return RTPU_OK;
}

int rtpu_store_contains(void* handle, const uint8_t* id) {
  auto* s = reinterpret_cast<Store*>(handle);
  lock(s);
  int64_t slot = table_find(s, id);
  int sealed = slot >= 0 && s->table[slot].state == kSealed;
  unlock(s);
  return sealed;
}

// Delete (or mark delete-pending if pinned).
int rtpu_store_delete(void* handle, const uint8_t* id) {
  auto* s = reinterpret_cast<Store*>(handle);
  lock(s);
  int64_t slot = table_find(s, id);
  if (slot < 0) {
    unlock(s);
    return RTPU_ERR_NOT_FOUND;
  }
  ObjectEntry* e = &s->table[slot];
  if (e->pin_count > 0) {
    e->flags |= 1;  // delete_pending
    unlock(s);
    return RTPU_ERR_PINNED;
  }
  delete_entry_locked(s, slot);
  unlock(s);
  return RTPU_OK;
}

struct StoreStats {
  uint64_t capacity;
  uint64_t bytes_used;
  uint64_t num_objects;
  uint64_t total_created;
  uint64_t total_evicted;
  uint64_t total_deleted;
  uint64_t eviction_bytes;
};

int rtpu_store_stats(void* handle, StoreStats* out) {
  auto* s = reinterpret_cast<Store*>(handle);
  lock(s);
  out->capacity = s->hdr->data_capacity;
  out->bytes_used = s->hdr->bytes_used;
  out->num_objects = s->hdr->num_objects;
  out->total_created = s->hdr->total_created;
  out->total_evicted = s->hdr->total_evicted;
  out->total_deleted = s->hdr->total_deleted;
  out->eviction_bytes = s->hdr->eviction_bytes;
  unlock(s);
  return RTPU_OK;
}

}  // extern "C"
