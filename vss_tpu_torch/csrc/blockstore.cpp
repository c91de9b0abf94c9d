// Fixed-size linked-block file store.
//
// The storage-native analog of the reference's LinkedBlock chains inside
// DuckDB's FixedSizeAllocator (duckdb-vss `src/hnsw/hnsw_index.cpp:
// 45-144`): named byte streams are stored as chains of fixed-size blocks
// with an in-file free list, so deleting and rewriting a stream (index
// drop/recreate, checkpoint rewrite) reuses blocks instead of growing the
// file — the behavior the reference's block-reclaim test exercises
// (`test/sql/slow/hnsw_reclaim_storage.test_slow`).
//
// File layout (little-endian, block_size B):
//   block 0 (superblock): magic "VSSBLK01" | u32 block_size | u32 reserved
//                         | i64 n_blocks | i64 free_head | i64 dir_head
//   data block:           i64 next | payload[B-8]
//   directory block chain (dir_head): packed entries
//       { char name[56]; i64 head; i64 length; }  (64+16 = 72 bytes each)
//
// C ABI for ctypes. Single-writer; no attempt at durability beyond
// fsync-on-close (matching the reference's checkpoint-time-only writes).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace {

constexpr char MAGIC[8] = {'V', 'S', 'S', 'B', 'L', 'K', '0', '1'};
constexpr int64_t NIL = -1;

struct DirEntry {
  int64_t head = NIL;
  int64_t length = 0;
};

struct Store {
  FILE* f = nullptr;
  uint32_t block_size = 0;
  int64_t n_blocks = 0;   // total blocks incl. superblock
  int64_t free_head = NIL;
  std::map<std::string, DirEntry> dir;
  std::string err;

  int64_t payload() const { return block_size - 8; }

  bool read_block(int64_t idx, std::vector<char>& buf) {
    buf.resize(block_size);
    if (fseeko(f, idx * static_cast<int64_t>(block_size), SEEK_SET)) return false;
    return fread(buf.data(), 1, block_size, f) == block_size;
  }

  bool write_block(int64_t idx, const char* data) {
    if (fseeko(f, idx * static_cast<int64_t>(block_size), SEEK_SET)) return false;
    return fwrite(data, 1, block_size, f) == block_size;
  }

  int64_t alloc_block() {
    if (free_head != NIL) {
      std::vector<char> buf;
      if (!read_block(free_head, buf)) return NIL;
      int64_t b = free_head;
      std::memcpy(&free_head, buf.data(), 8);
      return b;
    }
    return n_blocks++;
  }

  void free_chain(int64_t head) {
    std::vector<char> buf;
    while (head != NIL) {
      if (!read_block(head, buf)) return;
      int64_t next;
      std::memcpy(&next, buf.data(), 8);
      std::memcpy(buf.data(), &free_head, 8);
      write_block(head, buf.data());
      free_head = head;
      head = next;
    }
  }

  bool flush_meta() {
    // directory chain: free the old one, write the current map fresh
    if (have_dir_) {
      free_chain(dir_head_);
      have_dir_ = false;
    }
    std::vector<char> blob;
    for (const auto& [name, e] : dir) {
      char rec[72] = {0};
      std::snprintf(rec, 56, "%s", name.c_str());
      std::memcpy(rec + 56, &e.head, 8);
      std::memcpy(rec + 64, &e.length, 8);
      blob.insert(blob.end(), rec, rec + 72);
    }
    int64_t head = write_stream_blocks(blob.data(), blob.size());
    dir_head_ = head;
    have_dir_ = true;
    int64_t dir_len = static_cast<int64_t>(blob.size());
    // superblock last
    std::vector<char> buf(block_size, 0);
    std::memcpy(buf.data(), MAGIC, 8);
    std::memcpy(buf.data() + 8, &block_size, 4);
    std::memcpy(buf.data() + 16, &n_blocks, 8);
    std::memcpy(buf.data() + 24, &free_head, 8);
    std::memcpy(buf.data() + 32, &head, 8);
    std::memcpy(buf.data() + 40, &dir_len, 8);
    return write_block(0, buf.data());
  }

  int64_t write_stream_blocks(const char* data, int64_t len) {
    int64_t first = NIL, prev = NIL;
    int64_t off = 0;
    std::vector<char> buf(block_size, 0);
    if (len == 0) {
      // single empty block keeps the chain representable
      int64_t b = alloc_block();
      int64_t nil = NIL;
      std::memcpy(buf.data(), &nil, 8);
      write_block(b, buf.data());
      return b;
    }
    std::vector<int64_t> chain;
    while (off < len) {
      int64_t b = alloc_block();
      chain.push_back(b);
      off += payload();
    }
    off = 0;
    for (size_t i = 0; i < chain.size(); ++i) {
      int64_t next = (i + 1 < chain.size()) ? chain[i + 1] : NIL;
      std::memset(buf.data(), 0, block_size);
      std::memcpy(buf.data(), &next, 8);
      int64_t take = std::min<int64_t>(payload(), len - off);
      std::memcpy(buf.data() + 8, data + off, take);
      if (!write_block(chain[i], buf.data())) return NIL;
      off += take;
    }
    return chain.empty() ? NIL : chain[0];
  }

  bool read_stream_blocks(int64_t head, int64_t len, char* out) {
    std::vector<char> buf;
    int64_t off = 0;
    while (head != NIL && off < len) {
      if (!read_block(head, buf)) return false;
      int64_t next;
      std::memcpy(&next, buf.data(), 8);
      int64_t take = std::min<int64_t>(payload(), len - off);
      std::memcpy(out + off, buf.data() + 8, take);
      off += take;
      head = next;
    }
    return off >= len;
  }

  int64_t dir_head_ = NIL;
  bool have_dir_ = false;
};

Store* as_store(void* h) { return static_cast<Store*>(h); }

}  // namespace

extern "C" {

void* bs_open(const char* path, uint32_t block_size) {
  auto* s = new Store();
  s->f = std::fopen(path, "r+b");
  if (s->f == nullptr) {
    // create new
    s->f = std::fopen(path, "w+b");
    if (s->f == nullptr) {
      delete s;
      return nullptr;
    }
    s->block_size = block_size ? block_size : 262144;
    s->n_blocks = 1;
    s->free_head = NIL;
    if (!s->flush_meta()) {
      std::fclose(s->f);
      delete s;
      return nullptr;
    }
    return s;
  }
  // load existing
  char head[48];
  if (fread(head, 1, 48, s->f) != 48 || std::memcmp(head, MAGIC, 8) != 0) {
    std::fclose(s->f);
    delete s;
    return nullptr;
  }
  std::memcpy(&s->block_size, head + 8, 4);
  std::memcpy(&s->n_blocks, head + 16, 8);
  std::memcpy(&s->free_head, head + 24, 8);
  int64_t dir_head, dir_len;
  std::memcpy(&dir_head, head + 32, 8);
  std::memcpy(&dir_len, head + 40, 8);
  s->dir_head_ = dir_head;
  s->have_dir_ = dir_head != NIL;
  if (dir_head != NIL && dir_len > 0) {
    std::vector<char> blob(dir_len);
    if (!s->read_stream_blocks(dir_head, dir_len, blob.data())) {
      std::fclose(s->f);
      delete s;
      return nullptr;
    }
    for (int64_t off = 0; off + 72 <= dir_len; off += 72) {
      char name[57] = {0};
      std::memcpy(name, blob.data() + off, 56);
      DirEntry e;
      std::memcpy(&e.head, blob.data() + off + 56, 8);
      std::memcpy(&e.length, blob.data() + off + 64, 8);
      s->dir[name] = e;
    }
  }
  return s;
}

int bs_close(void* h) {
  auto* s = as_store(h);
  int rc = 0;
  if (s->f) {
    if (!s->flush_meta()) rc = 1;
    std::fflush(s->f);
    std::fclose(s->f);
  }
  delete s;
  return rc;
}

int bs_put(void* h, const char* name, const char* data, int64_t len) {
  auto* s = as_store(h);
  // Directory records hold the name in a fixed 56-byte field (flush_meta);
  // a longer name would silently truncate and could collide with another
  // stream sharing its 55-byte prefix after reopen. Reject instead.
  if (std::strlen(name) > 55) return 2;
  auto it = s->dir.find(name);
  if (it != s->dir.end()) {
    s->free_chain(it->second.head);
    s->dir.erase(it);
  }
  int64_t head = s->write_stream_blocks(data, len);
  if (head == NIL && len > 0) return 1;
  s->dir[name] = DirEntry{head, len};
  return 0;
}

int64_t bs_length(void* h, const char* name) {
  auto* s = as_store(h);
  auto it = s->dir.find(name);
  return it == s->dir.end() ? -1 : it->second.length;
}

int bs_get(void* h, const char* name, char* out, int64_t cap) {
  auto* s = as_store(h);
  auto it = s->dir.find(name);
  if (it == s->dir.end() || cap < it->second.length) return 1;
  return s->read_stream_blocks(it->second.head, it->second.length, out) ? 0 : 1;
}

int bs_delete(void* h, const char* name) {
  auto* s = as_store(h);
  auto it = s->dir.find(name);
  if (it == s->dir.end()) return 1;
  s->free_chain(it->second.head);
  s->dir.erase(it);
  return 0;
}

int64_t bs_total_blocks(void* h) { return as_store(h)->n_blocks; }

int64_t bs_free_blocks(void* h) {
  auto* s = as_store(h);
  int64_t cnt = 0;
  int64_t b = s->free_head;
  std::vector<char> buf;
  while (b != NIL) {
    ++cnt;
    if (!s->read_block(b, buf)) break;
    std::memcpy(&b, buf.data(), 8);
  }
  return cnt;
}

int64_t bs_list(void* h, char* out, int64_t cap) {
  auto* s = as_store(h);
  std::string joined;
  for (const auto& [name, _] : s->dir) {
    if (!joined.empty()) joined += '\n';
    joined += name;
  }
  int64_t len = static_cast<int64_t>(joined.size());
  if (out != nullptr && cap >= len) std::memcpy(out, joined.data(), len);
  return len;
}

}  // extern "C"
