// hgstore — native storage engine for hypergraphdb_tpu_torch.
//
// A copy of the JAX package's engine (hypergraphdb_tpu/native/hgstore.cpp),
// the counterpart of HyperGraphDB's native storage module
// (storage/bdb-native/: the HGStoreImplementation SPI over the BerkeleyDB C
// library via JNI). The on-disk formats are the same, so each package
// opens the other's stores. One change: hgs_bulk_links reports its counts
// as 64-bit integers, so a table past 2^32 - 1 entries cannot wrap them.
// Deliberately NOT a B-tree database: the rebuild's device plane wants the
// whole graph as flat arrays, so the native engine is a **log-structured
// columnar store**:
//
//   - all committed state lives in RAM in gather-friendly containers
//     (links: handle -> target vector; incidence: handle -> sorted vector;
//     indices: ordered key map -> sorted value vectors),
//   - durability = a write-ahead log (wal.log) of every mutation, replayed
//     on open (the analogue of BDB log replay in impl.startup, see
//     HyperGraph.java:50-54) + periodic compacted checkpoints
//     (checkpoint.bin) that truncate the log,
//   - bulk_links() exports the link table as three flat arrays in one call
//     — the zero-copy feed for CSR snapshot packing.
//
// Exposed as a C API (extern "C") consumed through ctypes from
// hypergraphdb_tpu_torch/storage/native.py. Single-writer, as the SPI specifies
// (storage/api.py): the Python transaction manager serializes commits.
//
// WAL record framing (v2, file starts with magic "HGW2"):
//   [u32 len][u32 crc32][u32 seq][u8 op][payload]
// len = 1 + payload bytes; crc32 covers (seq, op, payload); seq is a
// per-log monotonically increasing record number (reset when a checkpoint
// truncates the log). Replay verifies BOTH: a failed crc or a sequence
// discontinuity marks the end of the valid prefix and the tail is
// truncated — torn tails, bit rot, and interleaved/partial flushes are all
// caught, not just short reads (the reference's BDB log is checksummed the
// same way). Logs without the magic use the legacy length-only framing.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <set>
#include <string>
#include <unordered_map>
#include <vector>

#if defined(_WIN32)
#error "POSIX only"
#endif
#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

typedef int64_t i64;
typedef uint32_t u32;
typedef uint8_t u8;

// WAL v2 file magic + CRC32 (IEEE 802.3 polynomial, table-driven)
const char kWalMagic[4] = {'H', 'G', 'W', '2'};

u32 crc32_update(u32 crc, const void* data, size_t n) {
  static u32 table[256];
  static bool init = false;
  if (!init) {
    for (u32 i = 0; i < 256; ++i) {
      u32 c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    init = true;
  }
  const u8* p = static_cast<const u8*>(data);
  crc = ~crc;
  for (size_t i = 0; i < n; ++i) crc = table[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

u32 wal_record_crc(u32 seq, u8 op, const char* payload, size_t n) {
  u32 c = crc32_update(0, &seq, 4);
  c = crc32_update(c, &op, 1);
  return crc32_update(c, payload, n);
}

enum Op : u8 {
  OP_STORE_LINK = 1,
  OP_REMOVE_LINK = 2,
  OP_STORE_DATA = 3,
  OP_REMOVE_DATA = 4,
  OP_INC_ADD = 5,
  OP_INC_REMOVE = 6,
  OP_INC_CLEAR = 7,
  OP_IDX_ADD = 8,
  OP_IDX_REMOVE = 9,
  OP_IDX_REMOVE_ALL = 10,
  OP_IDX_DROP = 11,
  OP_IDX_TOUCH = 12,
  OP_BATCH_BEGIN = 13,
  OP_BATCH_COMMIT = 14,
  OP_BATCH_ABORT = 15,
};

struct Index {
  // ordered key -> ascending-sorted values; memcmp order == key order
  // (keys are the order-preserving byte encodings from utils/ordered_bytes)
  std::map<std::string, std::vector<i64>> entries;
  // value -> keys holding it (HGBidirectionalIndex contract)
  std::unordered_map<i64, std::set<std::string>> by_value;

  void add(const std::string& key, i64 v) {
    std::vector<i64>& vec = entries[key];
    std::vector<i64>::iterator it =
        std::lower_bound(vec.begin(), vec.end(), v);
    if (it == vec.end() || *it != v) vec.insert(it, v);
    by_value[v].insert(key);
  }
  void remove(const std::string& key, i64 v) {
    std::map<std::string, std::vector<i64>>::iterator e = entries.find(key);
    if (e != entries.end()) {
      std::vector<i64>& vec = e->second;
      std::vector<i64>::iterator it =
          std::lower_bound(vec.begin(), vec.end(), v);
      if (it != vec.end() && *it == v) vec.erase(it);
      if (vec.empty()) entries.erase(e);
    }
    std::unordered_map<i64, std::set<std::string>>::iterator b =
        by_value.find(v);
    if (b != by_value.end()) {
      b->second.erase(key);
      if (b->second.empty()) by_value.erase(b);
    }
  }
  void remove_all(const std::string& key) {
    std::map<std::string, std::vector<i64>>::iterator e = entries.find(key);
    if (e == entries.end()) return;
    for (size_t i = 0; i < e->second.size(); ++i) {
      i64 v = e->second[i];
      std::unordered_map<i64, std::set<std::string>>::iterator b =
          by_value.find(v);
      if (b != by_value.end()) {
        b->second.erase(key);
        if (b->second.empty()) by_value.erase(b);
      }
    }
    entries.erase(e);
  }
};

struct Store {
  std::string dir;
  FILE* wal = nullptr;
  bool replaying = false;
  bool wal_ok = true;    // sticky: any WAL write failure latches false
  bool in_batch = false; // commit batch open: defer flush to batch commit
  u32 wal_seq = 0;       // next record sequence number (v2 framing)

  std::unordered_map<i64, std::vector<i64>> links;
  std::unordered_map<i64, std::string> data;
  std::unordered_map<i64, std::vector<i64>> incidence;  // sorted
  std::map<std::string, Index> indices;
  i64 max_handle = 0;

  std::string wal_path() const { return dir + "/wal.log"; }
  std::string ckpt_path() const { return dir + "/checkpoint.bin"; }

  void note_handle(i64 h) {
    if (h + 1 > max_handle) max_handle = h + 1;
  }
};

// ---------------------------------------------------------------- WAL I/O

void w_bytes(std::string& buf, const void* p, size_t n) {
  buf.append(reinterpret_cast<const char*>(p), n);
}
void w_i64(std::string& buf, i64 v) { w_bytes(buf, &v, 8); }
void w_u32(std::string& buf, u32 v) { w_bytes(buf, &v, 4); }
void w_blob(std::string& buf, const char* p, u32 n) {
  w_u32(buf, n);
  w_bytes(buf, p, n);
}

struct Reader {
  const char* p;
  const char* end;
  bool ok = true;
  bool need(size_t n) {
    if (static_cast<size_t>(end - p) < n) {
      ok = false;
      return false;
    }
    return true;
  }
  i64 r_i64() {
    if (!need(8)) return 0;
    i64 v;
    memcpy(&v, p, 8);
    p += 8;
    return v;
  }
  u32 r_u32() {
    if (!need(4)) return 0;
    u32 v;
    memcpy(&v, p, 4);
    p += 4;
    return v;
  }
  std::string r_blob() {
    u32 n = r_u32();
    if (!need(n)) return std::string();
    std::string s(p, n);
    p += n;
    return s;
  }
};

void wal_append(Store* s, u8 op, const std::string& payload) {
  if (s->replaying) return;
  if (!s->wal) {  // e.g. checkpoint failed to reopen the log
    s->wal_ok = false;
    return;
  }
  u32 len = static_cast<u32>(payload.size()) + 1;
  u32 seq = s->wal_seq++;
  u32 crc = wal_record_crc(seq, op, payload.data(), payload.size());
  bool ok = fwrite(&len, 4, 1, s->wal) == 1 &&
            fwrite(&crc, 4, 1, s->wal) == 1 &&
            fwrite(&seq, 4, 1, s->wal) == 1 &&
            fwrite(&op, 1, 1, s->wal) == 1 &&
            fwrite(payload.data(), 1, payload.size(), s->wal) ==
                payload.size();
  // fflush pushes into the kernel page cache: survives process death (the
  // AbruptExit contract); fsync-on-checkpoint covers OS crash. Inside a
  // commit batch the flush is deferred to the OP_BATCH_COMMIT barrier.
  if (ok && !s->in_batch) ok = fflush(s->wal) == 0;
  if (!ok) s->wal_ok = false;  // sticky; surfaced via hgs_wal_ok
}

// ---------------------------------------------------------------- mutations

void do_store_link(Store* s, i64 h, const i64* targets, u32 n) {
  std::vector<i64>& vec = s->links[h];
  vec.assign(targets, targets + n);
  s->note_handle(h);
  for (u32 i = 0; i < n; ++i) s->note_handle(targets[i]);
}

void do_remove_link(Store* s, i64 h) { s->links.erase(h); }

void do_store_data(Store* s, i64 h, const char* bytes, u32 n) {
  s->data[h].assign(bytes, n);
  s->note_handle(h);
}

void do_remove_data(Store* s, i64 h) { s->data.erase(h); }

void do_inc_add(Store* s, i64 atom, i64 link) {
  std::vector<i64>& vec = s->incidence[atom];
  std::vector<i64>::iterator it =
      std::lower_bound(vec.begin(), vec.end(), link);
  if (it == vec.end() || *it != link) vec.insert(it, link);
  s->note_handle(atom);
  s->note_handle(link);
}

void do_inc_remove(Store* s, i64 atom, i64 link) {
  std::unordered_map<i64, std::vector<i64>>::iterator e =
      s->incidence.find(atom);
  if (e == s->incidence.end()) return;
  std::vector<i64>& vec = e->second;
  std::vector<i64>::iterator it =
      std::lower_bound(vec.begin(), vec.end(), link);
  if (it != vec.end() && *it == link) vec.erase(it);
  if (vec.empty()) s->incidence.erase(e);
}

void do_inc_clear(Store* s, i64 atom) { s->incidence.erase(atom); }

void apply_record(Store* s, u8 op, Reader& r) {
  switch (op) {
    case OP_STORE_LINK: {
      i64 h = r.r_i64();
      u32 n = r.r_u32();
      if (!r.need(8ull * n)) return;
      std::vector<i64> ts(n);
      if (n) memcpy(ts.data(), r.p, 8ull * n);
      r.p += 8ull * n;
      do_store_link(s, h, ts.data(), n);
      break;
    }
    case OP_REMOVE_LINK:
      do_remove_link(s, r.r_i64());
      break;
    case OP_STORE_DATA: {
      i64 h = r.r_i64();
      std::string b = r.r_blob();
      if (r.ok) do_store_data(s, h, b.data(), static_cast<u32>(b.size()));
      break;
    }
    case OP_REMOVE_DATA:
      do_remove_data(s, r.r_i64());
      break;
    case OP_INC_ADD: {
      i64 a = r.r_i64(), l = r.r_i64();
      if (r.ok) do_inc_add(s, a, l);
      break;
    }
    case OP_INC_REMOVE: {
      i64 a = r.r_i64(), l = r.r_i64();
      if (r.ok) do_inc_remove(s, a, l);
      break;
    }
    case OP_INC_CLEAR:
      do_inc_clear(s, r.r_i64());
      break;
    case OP_IDX_ADD: {
      std::string name = r.r_blob(), key = r.r_blob();
      i64 v = r.r_i64();
      if (r.ok) s->indices[name].add(key, v);
      break;
    }
    case OP_IDX_REMOVE: {
      std::string name = r.r_blob(), key = r.r_blob();
      i64 v = r.r_i64();
      if (r.ok) {
        std::map<std::string, Index>::iterator it = s->indices.find(name);
        if (it != s->indices.end()) it->second.remove(key, v);
      }
      break;
    }
    case OP_IDX_REMOVE_ALL: {
      std::string name = r.r_blob(), key = r.r_blob();
      if (r.ok) {
        std::map<std::string, Index>::iterator it = s->indices.find(name);
        if (it != s->indices.end()) it->second.remove_all(key);
      }
      break;
    }
    case OP_IDX_DROP: {
      std::string name = r.r_blob();
      if (r.ok) s->indices.erase(name);
      break;
    }
    case OP_IDX_TOUCH: {
      std::string name = r.r_blob();
      if (r.ok) s->indices[name];
      break;
    }
    default:
      break;
  }
}

// ---------------------------------------------------------------- checkpoint

const u32 CKPT_MAGIC = 0x48475354;  // "HGST"
const u32 CKPT_VERSION = 1;

bool write_all(FILE* f, const void* p, size_t n) {
  return fwrite(p, 1, n, f) == n;
}

bool save_checkpoint(Store* s) {
  std::string tmp = s->ckpt_path() + ".tmp";
  FILE* f = fopen(tmp.c_str(), "wb");
  if (!f) return false;
  std::string buf;
  w_u32(buf, CKPT_MAGIC);
  w_u32(buf, CKPT_VERSION);
  w_i64(buf, s->max_handle);
  w_u32(buf, static_cast<u32>(s->links.size()));
  for (std::unordered_map<i64, std::vector<i64>>::const_iterator it =
           s->links.begin();
       it != s->links.end(); ++it) {
    w_i64(buf, it->first);
    w_u32(buf, static_cast<u32>(it->second.size()));
    w_bytes(buf, it->second.data(), it->second.size() * 8);
  }
  w_u32(buf, static_cast<u32>(s->data.size()));
  for (std::unordered_map<i64, std::string>::const_iterator it =
           s->data.begin();
       it != s->data.end(); ++it) {
    w_i64(buf, it->first);
    w_blob(buf, it->second.data(), static_cast<u32>(it->second.size()));
  }
  w_u32(buf, static_cast<u32>(s->incidence.size()));
  for (std::unordered_map<i64, std::vector<i64>>::const_iterator it =
           s->incidence.begin();
       it != s->incidence.end(); ++it) {
    w_i64(buf, it->first);
    w_u32(buf, static_cast<u32>(it->second.size()));
    w_bytes(buf, it->second.data(), it->second.size() * 8);
  }
  w_u32(buf, static_cast<u32>(s->indices.size()));
  for (std::map<std::string, Index>::const_iterator it = s->indices.begin();
       it != s->indices.end(); ++it) {
    w_blob(buf, it->first.data(), static_cast<u32>(it->first.size()));
    w_u32(buf, static_cast<u32>(it->second.entries.size()));
    for (std::map<std::string, std::vector<i64>>::const_iterator e =
             it->second.entries.begin();
         e != it->second.entries.end(); ++e) {
      w_blob(buf, e->first.data(), static_cast<u32>(e->first.size()));
      w_u32(buf, static_cast<u32>(e->second.size()));
      w_bytes(buf, e->second.data(), e->second.size() * 8);
    }
  }
  bool ok = write_all(f, buf.data(), buf.size());
  ok = ok && fflush(f) == 0 && fsync(fileno(f)) == 0;
  fclose(f);
  if (!ok) {
    remove(tmp.c_str());
    return false;
  }
  if (rename(tmp.c_str(), s->ckpt_path().c_str()) != 0) return false;
  // make the rename durable before the caller truncates the WAL: without a
  // directory fsync, POSIX gives no ordering between the rename and the
  // truncation reaching disk, and a power cut could surface the truncated
  // WAL with the OLD checkpoint
  int dfd = open(s->dir.c_str(), O_RDONLY | O_DIRECTORY);
  if (dfd < 0) return false;
  bool synced = fsync(dfd) == 0;
  close(dfd);
  return synced;
}

bool load_checkpoint(Store* s) {
  FILE* f = fopen(s->ckpt_path().c_str(), "rb");
  if (!f) return true;  // no checkpoint yet
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(static_cast<size_t>(sz), '\0');
  size_t got = fread(&buf[0], 1, static_cast<size_t>(sz), f);
  fclose(f);
  if (got != static_cast<size_t>(sz)) return false;
  Reader r{buf.data(), buf.data() + buf.size()};
  if (r.r_u32() != CKPT_MAGIC || r.r_u32() != CKPT_VERSION) return false;
  s->max_handle = r.r_i64();
  u32 nl = r.r_u32();
  for (u32 i = 0; i < nl && r.ok; ++i) {
    i64 h = r.r_i64();
    u32 n = r.r_u32();
    if (!r.need(8ull * n)) break;
    std::vector<i64>& vec = s->links[h];
    vec.resize(n);
    if (n) memcpy(vec.data(), r.p, 8ull * n);
    r.p += 8ull * n;
  }
  u32 nd = r.r_u32();
  for (u32 i = 0; i < nd && r.ok; ++i) {
    i64 h = r.r_i64();
    s->data[h] = r.r_blob();
  }
  u32 ni = r.r_u32();
  for (u32 i = 0; i < ni && r.ok; ++i) {
    i64 h = r.r_i64();
    u32 n = r.r_u32();
    if (!r.need(8ull * n)) break;
    std::vector<i64>& vec = s->incidence[h];
    vec.resize(n);
    if (n) memcpy(vec.data(), r.p, 8ull * n);
    r.p += 8ull * n;
  }
  u32 nx = r.r_u32();
  for (u32 i = 0; i < nx && r.ok; ++i) {
    std::string name = r.r_blob();
    Index& idx = s->indices[name];
    u32 nk = r.r_u32();
    for (u32 k = 0; k < nk && r.ok; ++k) {
      std::string key = r.r_blob();
      u32 nv = r.r_u32();
      if (!r.need(8ull * nv)) break;
      std::vector<i64>& vec = idx.entries[key];
      vec.resize(nv);
      if (nv) memcpy(vec.data(), r.p, 8ull * nv);
      r.p += 8ull * nv;
      for (u32 v = 0; v < nv; ++v) idx.by_value[vec[v]].insert(key);
    }
  }
  return r.ok;
}

bool replay_wal(Store* s) {
  FILE* f = fopen(s->wal_path().c_str(), "rb");
  if (!f) return true;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(static_cast<size_t>(sz), '\0');
  size_t got = fread(&buf[0], 1, static_cast<size_t>(sz), f);
  fclose(f);
  if (got != static_cast<size_t>(sz)) return false;
  s->replaying = true;
  const char* p = buf.data();
  const char* end = p + buf.size();
  long good = 0;
  bool v2 = buf.size() >= 4 && memcmp(p, kWalMagic, 4) == 0;
  if (v2) {
    p += 4;
    good = 4;
  }
  const size_t head = v2 ? 13 : 5;  // len+crc+seq+op | len+op
  u32 expect_seq = 0;
  u32 good_seq = 0;
  // Commit-batch replay: records between OP_BATCH_BEGIN and OP_BATCH_COMMIT
  // are buffered and applied atomically at the commit barrier; a crash
  // mid-commit leaves an unterminated batch, which is discarded — no
  // half-applied transactions survive. Records outside a batch (standalone
  // ops, e.g. non-transactional mode) apply immediately.
  std::vector<std::pair<u8, std::pair<const char*, const char*>>> pending;
  bool batch = false;
  while (static_cast<size_t>(end - p) >= head) {
    u32 len;
    memcpy(&len, p, 4);
    const char* rec = p + (head - 1);  // points at the op byte
    if (static_cast<size_t>(end - rec) < len || len == 0) break;  // torn tail
    u8 op = static_cast<u8>(rec[0]);
    const char* body = rec + 1;
    const char* body_end = rec + len;
    if (v2) {
      u32 crc, seq;
      memcpy(&crc, p + 4, 4);
      memcpy(&seq, p + 8, 4);
      if (seq != expect_seq ||
          crc != wal_record_crc(seq, op, body, body_end - body))
        break;  // corruption: valid prefix ends here
      ++expect_seq;
    }
    const long rec_total = static_cast<long>(head - 1) + len;
    if (op == OP_BATCH_BEGIN) {
      pending.clear();
      batch = true;
    } else if (op == OP_BATCH_COMMIT) {
      for (size_t i = 0; i < pending.size(); ++i) {
        Reader r{pending[i].second.first, pending[i].second.second};
        apply_record(s, pending[i].first, r);
      }
      pending.clear();
      batch = false;
      good = (p + rec_total) - buf.data();
      good_seq = expect_seq;
    } else if (op == OP_BATCH_ABORT) {
      pending.clear();
      batch = false;
      good = (p + rec_total) - buf.data();
      good_seq = expect_seq;
    } else if (batch) {
      pending.push_back(std::make_pair(
          op, std::make_pair(body, body_end)));
    } else {
      Reader r{body, body_end};
      apply_record(s, op, r);
      good = (p + rec_total) - buf.data();
      good_seq = expect_seq;
    }
    p += rec_total;
  }
  s->replaying = false;
  // appends continue the sequence of the last KEPT record: everything past
  // `good` (e.g. a verified-but-unterminated batch) is truncated below, so
  // its sequence numbers are legitimately reused
  if (v2) s->wal_seq = good_seq;
  if (good < sz) {
    // truncate the torn tail so the next append starts at a clean boundary
    if (truncate(s->wal_path().c_str(), good) != 0) return false;
  }
  return true;
}

// ---------------------------------------------------------------- out buffers

char* out_alloc(size_t n) { return static_cast<char*>(malloc(n ? n : 1)); }

}  // namespace

// ================================================================ C API

extern "C" {

Store* hgs_open(const char* path) {
  Store* s = new Store();
  s->dir = path;
  mkdir(path, 0755);  // ok if exists
  if (!load_checkpoint(s) || !replay_wal(s)) {
    delete s;
    return nullptr;
  }
  s->wal = fopen(s->wal_path().c_str(), "ab");
  if (!s->wal) {
    delete s;
    return nullptr;
  }
  fseek(s->wal, 0, SEEK_END);
  long wal_size = ftell(s->wal);
  if (wal_size == 0) {
    // fresh log: start with the v2 magic so every record is checksummed
    if (fwrite(kWalMagic, 1, 4, s->wal) != 4 || fflush(s->wal) != 0)
      s->wal_ok = false;
    s->wal_seq = 0;
  } else if (s->wal_seq == 0 && wal_size > 4) {
    // non-empty log that replayed WITHOUT v2 sequencing = legacy framing.
    // Its state is fully loaded, so convert once: checkpoint + truncate
    // rewrites the log as v2 (appending unchecksummed frames forever
    // would defeat the point of the CRC).
    FILE* probe = fopen(s->wal_path().c_str(), "rb");
    char m[4] = {0, 0, 0, 0};
    bool is_v2 = probe && fread(m, 1, 4, probe) == 4 &&
                 memcmp(m, kWalMagic, 4) == 0;
    if (probe) fclose(probe);
    if (!is_v2) {
      fclose(s->wal);
      s->wal = nullptr;
      if (!save_checkpoint(s)) {
        delete s;
        return nullptr;
      }
      s->wal = fopen(s->wal_path().c_str(), "wb");
      if (!s->wal) {
        delete s;
        return nullptr;
      }
      if (fwrite(kWalMagic, 1, 4, s->wal) != 4 || fflush(s->wal) != 0)
        s->wal_ok = false;
      s->wal_seq = 0;
    }
  }
  return s;
}

void hgs_close(Store* s) {
  if (!s) return;
  if (s->wal) fclose(s->wal);
  delete s;
}

// checkpoint: compact state to disk, truncate the WAL
int hgs_checkpoint(Store* s) {
  if (!save_checkpoint(s)) return -1;
  if (s->wal) fclose(s->wal);
  s->wal = fopen(s->wal_path().c_str(), "wb");  // truncate
  if (!s->wal) {
    s->wal_ok = false;  // nothing can be logged until reopen
    return -1;
  }
  if (fwrite(kWalMagic, 1, 4, s->wal) != 4 || fflush(s->wal) != 0)
    s->wal_ok = false;
  s->wal_seq = 0;  // a fresh log restarts the record sequence
  return 0;
}

void hgs_free(void* p) { free(p); }

// 1 while every WAL write so far has fully reached the OS; latches 0 on the
// first failure (disk full, IO error) so callers can surface lost durability
int hgs_wal_ok(Store* s) { return s->wal_ok ? 1 : 0; }

// commit-batch barriers: mutations between begin and commit replay
// atomically (all or nothing) after a crash
void hgs_batch_begin(Store* s) {
  wal_append(s, OP_BATCH_BEGIN, std::string());
  s->in_batch = true;
}

void hgs_batch_commit(Store* s) {
  s->in_batch = false;
  wal_append(s, OP_BATCH_COMMIT, std::string());
}

// abort: the batch's records stay in the log but replay discards them at
// this barrier — the durable image never shows a half-applied commit
void hgs_batch_abort(Store* s) {
  s->in_batch = false;
  wal_append(s, OP_BATCH_ABORT, std::string());
}

i64 hgs_max_handle(Store* s) { return s->max_handle; }

// -- links ------------------------------------------------------------

void hgs_store_link(Store* s, i64 h, const i64* targets, u32 n) {
  std::string pl;
  w_i64(pl, h);
  w_u32(pl, n);
  w_bytes(pl, targets, 8ull * n);
  wal_append(s, OP_STORE_LINK, pl);
  do_store_link(s, h, targets, n);
}

// returns 1 if present; *out (malloc'd) holds n targets
int hgs_get_link(Store* s, i64 h, i64** out, u32* n) {
  std::unordered_map<i64, std::vector<i64>>::const_iterator it =
      s->links.find(h);
  if (it == s->links.end()) return 0;
  *n = static_cast<u32>(it->second.size());
  *out = reinterpret_cast<i64*>(out_alloc(8ull * *n));
  if (*n) memcpy(*out, it->second.data(), 8ull * *n);
  return 1;
}

void hgs_remove_link(Store* s, i64 h) {
  std::string pl;
  w_i64(pl, h);
  wal_append(s, OP_REMOVE_LINK, pl);
  do_remove_link(s, h);
}

int hgs_contains_link(Store* s, i64 h) {
  return s->links.count(h) ? 1 : 0;
}

u32 hgs_link_count(Store* s) { return static_cast<u32>(s->links.size()); }

// bulk export: ids ascending + CSR offsets + flat targets (CSR-pack feed).
// The counts are 64-bit: a u32 would wrap past 2^32 - 1 links or targets.
void hgs_bulk_links(Store* s, i64** ids, i64** offsets, i64** flat,
                    uint64_t* n_links, uint64_t* n_flat) {
  std::vector<i64> sorted_ids;
  sorted_ids.reserve(s->links.size());
  size_t total = 0;
  for (std::unordered_map<i64, std::vector<i64>>::const_iterator it =
           s->links.begin();
       it != s->links.end(); ++it) {
    sorted_ids.push_back(it->first);
    total += it->second.size();
  }
  std::sort(sorted_ids.begin(), sorted_ids.end());
  *n_links = static_cast<uint64_t>(sorted_ids.size());
  *n_flat = static_cast<uint64_t>(total);
  *ids = reinterpret_cast<i64*>(out_alloc(8ull * sorted_ids.size()));
  *offsets = reinterpret_cast<i64*>(out_alloc(8ull * (sorted_ids.size() + 1)));
  *flat = reinterpret_cast<i64*>(out_alloc(8ull * total));
  i64 off = 0;
  for (size_t i = 0; i < sorted_ids.size(); ++i) {
    (*ids)[i] = sorted_ids[i];
    (*offsets)[i] = off;
    const std::vector<i64>& ts = s->links[sorted_ids[i]];
    if (!ts.empty()) memcpy(*flat + off, ts.data(), 8ull * ts.size());
    off += static_cast<i64>(ts.size());
  }
  (*offsets)[sorted_ids.size()] = off;
}

// -- data -------------------------------------------------------------

void hgs_store_data(Store* s, i64 h, const char* bytes, u32 n) {
  std::string pl;
  w_i64(pl, h);
  w_blob(pl, bytes, n);
  wal_append(s, OP_STORE_DATA, pl);
  do_store_data(s, h, bytes, n);
}

int hgs_get_data(Store* s, i64 h, char** out, u32* n) {
  std::unordered_map<i64, std::string>::const_iterator it = s->data.find(h);
  if (it == s->data.end()) return 0;
  *n = static_cast<u32>(it->second.size());
  *out = out_alloc(*n);
  if (*n) memcpy(*out, it->second.data(), *n);
  return 1;
}

void hgs_remove_data(Store* s, i64 h) {
  std::string pl;
  w_i64(pl, h);
  wal_append(s, OP_REMOVE_DATA, pl);
  do_remove_data(s, h);
}

// -- incidence ---------------------------------------------------------

void hgs_inc_add(Store* s, i64 atom, i64 link) {
  std::string pl;
  w_i64(pl, atom);
  w_i64(pl, link);
  wal_append(s, OP_INC_ADD, pl);
  do_inc_add(s, atom, link);
}

void hgs_inc_remove(Store* s, i64 atom, i64 link) {
  std::string pl;
  w_i64(pl, atom);
  w_i64(pl, link);
  wal_append(s, OP_INC_REMOVE, pl);
  do_inc_remove(s, atom, link);
}

void hgs_inc_clear(Store* s, i64 atom) {
  std::string pl;
  w_i64(pl, atom);
  wal_append(s, OP_INC_CLEAR, pl);
  do_inc_clear(s, atom);
}

void hgs_inc_get(Store* s, i64 atom, i64** out, u32* n) {
  std::unordered_map<i64, std::vector<i64>>::const_iterator it =
      s->incidence.find(atom);
  if (it == s->incidence.end()) {
    *n = 0;
    *out = reinterpret_cast<i64*>(out_alloc(0));
    return;
  }
  *n = static_cast<u32>(it->second.size());
  *out = reinterpret_cast<i64*>(out_alloc(8ull * *n));
  if (*n) memcpy(*out, it->second.data(), 8ull * *n);
}

u32 hgs_inc_count(Store* s, i64 atom) {
  std::unordered_map<i64, std::vector<i64>>::const_iterator it =
      s->incidence.find(atom);
  return it == s->incidence.end() ? 0 : static_cast<u32>(it->second.size());
}

// -- indices -----------------------------------------------------------

void hgs_idx_add(Store* s, const char* name, const char* key, u32 klen,
                 i64 v) {
  std::string nm(name), k(key, klen), pl;
  w_blob(pl, nm.data(), static_cast<u32>(nm.size()));
  w_blob(pl, k.data(), klen);
  w_i64(pl, v);
  wal_append(s, OP_IDX_ADD, pl);
  s->indices[nm].add(k, v);
}

void hgs_idx_remove(Store* s, const char* name, const char* key, u32 klen,
                    i64 v) {
  std::string nm(name), k(key, klen), pl;
  w_blob(pl, nm.data(), static_cast<u32>(nm.size()));
  w_blob(pl, k.data(), klen);
  w_i64(pl, v);
  wal_append(s, OP_IDX_REMOVE, pl);
  std::map<std::string, Index>::iterator it = s->indices.find(nm);
  if (it != s->indices.end()) it->second.remove(k, v);
}

void hgs_idx_remove_all(Store* s, const char* name, const char* key,
                        u32 klen) {
  std::string nm(name), k(key, klen), pl;
  w_blob(pl, nm.data(), static_cast<u32>(nm.size()));
  w_blob(pl, k.data(), klen);
  wal_append(s, OP_IDX_REMOVE_ALL, pl);
  std::map<std::string, Index>::iterator it = s->indices.find(nm);
  if (it != s->indices.end()) it->second.remove_all(k);
}

void hgs_idx_drop(Store* s, const char* name) {
  std::string nm(name), pl;
  w_blob(pl, nm.data(), static_cast<u32>(nm.size()));
  wal_append(s, OP_IDX_DROP, pl);
  s->indices.erase(nm);
}

// ensure the index exists (get_index(create=True) semantics); WAL'd so an
// index created empty survives reopen like it does on the memory backend
void hgs_idx_touch(Store* s, const char* name) {
  std::string nm(name);
  if (!s->indices.count(nm)) {
    std::string pl;
    w_blob(pl, nm.data(), static_cast<u32>(nm.size()));
    wal_append(s, OP_IDX_TOUCH, pl);
  }
  s->indices[nm];
}

int hgs_idx_exists(Store* s, const char* name) {
  return s->indices.count(name) ? 1 : 0;
}

void hgs_idx_find(Store* s, const char* name, const char* key, u32 klen,
                  i64** out, u32* n) {
  *n = 0;
  *out = nullptr;
  std::map<std::string, Index>::const_iterator it = s->indices.find(name);
  if (it == s->indices.end()) {
    *out = reinterpret_cast<i64*>(out_alloc(0));
    return;
  }
  std::map<std::string, std::vector<i64>>::const_iterator e =
      it->second.entries.find(std::string(key, klen));
  if (e == it->second.entries.end()) {
    *out = reinterpret_cast<i64*>(out_alloc(0));
    return;
  }
  *n = static_cast<u32>(e->second.size());
  *out = reinterpret_cast<i64*>(out_alloc(8ull * *n));
  if (*n) memcpy(*out, e->second.data(), 8ull * *n);
}

// range scan over [lo, hi] with inclusivity flags; null bound = open end.
// Returns the UNION of value sets over keys in range, ascending & deduped.
void hgs_idx_range(Store* s, const char* name, const char* lo, u32 lo_len,
                   int has_lo, int lo_incl, const char* hi, u32 hi_len,
                   int has_hi, int hi_incl, i64** out, u32* n) {
  *n = 0;
  std::map<std::string, Index>::const_iterator it = s->indices.find(name);
  if (it == s->indices.end()) {
    *out = reinterpret_cast<i64*>(out_alloc(0));
    return;
  }
  const std::map<std::string, std::vector<i64>>& m = it->second.entries;
  std::map<std::string, std::vector<i64>>::const_iterator b, e;
  if (has_lo) {
    std::string k(lo, lo_len);
    b = lo_incl ? m.lower_bound(k) : m.upper_bound(k);
  } else {
    b = m.begin();
  }
  if (has_hi) {
    std::string k(hi, hi_len);
    e = hi_incl ? m.upper_bound(k) : m.lower_bound(k);
  } else {
    e = m.end();
  }
  std::vector<i64> acc;
  for (; b != e; ++b) acc.insert(acc.end(), b->second.begin(), b->second.end());
  std::sort(acc.begin(), acc.end());
  acc.erase(std::unique(acc.begin(), acc.end()), acc.end());
  *n = static_cast<u32>(acc.size());
  *out = reinterpret_cast<i64*>(out_alloc(8ull * acc.size()));
  if (*n) memcpy(*out, acc.data(), 8ull * acc.size());
}

u32 hgs_idx_key_count(Store* s, const char* name) {
  std::map<std::string, Index>::const_iterator it = s->indices.find(name);
  return it == s->indices.end() ? 0
                                : static_cast<u32>(it->second.entries.size());
}

// all keys, concatenated as [u32 len][bytes]...; caller frees
void hgs_idx_scan_keys(Store* s, const char* name, char** out, u32* total,
                       u32* count) {
  *total = 0;
  *count = 0;
  std::map<std::string, Index>::const_iterator it = s->indices.find(name);
  std::string buf;
  if (it != s->indices.end()) {
    for (std::map<std::string, std::vector<i64>>::const_iterator e =
             it->second.entries.begin();
         e != it->second.entries.end(); ++e) {
      w_blob(buf, e->first.data(), static_cast<u32>(e->first.size()));
      ++*count;
    }
  }
  *total = static_cast<u32>(buf.size());
  *out = out_alloc(buf.size());
  if (!buf.empty()) memcpy(*out, buf.data(), buf.size());
}

// keys holding a value, same framing as scan_keys
void hgs_idx_find_by_value(Store* s, const char* name, i64 v, char** out,
                           u32* total, u32* count) {
  *total = 0;
  *count = 0;
  std::string buf;
  std::map<std::string, Index>::const_iterator it = s->indices.find(name);
  if (it != s->indices.end()) {
    std::unordered_map<i64, std::set<std::string>>::const_iterator b =
        it->second.by_value.find(v);
    if (b != it->second.by_value.end()) {
      for (std::set<std::string>::const_iterator k = b->second.begin();
           k != b->second.end(); ++k) {
        w_blob(buf, k->data(), static_cast<u32>(k->size()));
        ++*count;
      }
    }
  }
  *total = static_cast<u32>(buf.size());
  *out = out_alloc(buf.size());
  if (!buf.empty()) memcpy(*out, buf.data(), buf.size());
}

// index names, same framing
void hgs_idx_names(Store* s, char** out, u32* total, u32* count) {
  std::string buf;
  *count = 0;
  for (std::map<std::string, Index>::const_iterator it = s->indices.begin();
       it != s->indices.end(); ++it) {
    w_blob(buf, it->first.data(), static_cast<u32>(it->first.size()));
    ++*count;
  }
  *total = static_cast<u32>(buf.size());
  *out = out_alloc(buf.size());
  if (!buf.empty()) memcpy(*out, buf.data(), buf.size());
}

}  // extern "C"
