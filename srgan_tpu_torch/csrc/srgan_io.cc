// srgan_io — native host-side data runtime for srgan_tpu_torch.
//
// Memory-mapped .npy datasets and a threaded crop-gather prefetcher with
// a bounded ring queue, in process: the host-side input of the crowd
// app's host tier (crowd_host_pipeline), for a database larger than the
// card's memory. The resident tier's patch-sampler kernel
// (csrc/patches.cu) stays the path for a database on the card. The
// port's own copy of the JAX package's host-IO runtime: the same C ABI,
// so that both packages' wrappers read the same datasets alike.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
//
// Layout contract: datasets are 4-D .npy arrays [N, H, W, C], dtype
// '<f4' (float32) or '|u1' (uint8), C-order.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Reader {
  void* map = nullptr;
  size_t map_size = 0;
  const uint8_t* data = nullptr;  // first element, after the npy header
  int64_t dims[4] = {0, 0, 0, 0};
  bool is_f32 = false;  // else u8
  int64_t item_size() const { return is_f32 ? 4 : 1; }
  int64_t n() const { return dims[0]; }
  int64_t h() const { return dims[1]; }
  int64_t w() const { return dims[2]; }
  int64_t c() const { return dims[3]; }
};

// Minimal .npy v1/v2 header parser (magic, header dict with descr /
// fortran_order / shape).
bool parse_npy(const uint8_t* buf, size_t size, Reader* r) {
  if (size < 10 || std::memcmp(buf, "\x93NUMPY", 6) != 0) return false;
  const uint8_t major = buf[6];
  size_t header_len, header_off;
  if (major == 1) {
    header_len = buf[8] | (buf[9] << 8);
    header_off = 10;
  } else {
    if (size < 12) return false;
    header_len = buf[8] | (buf[9] << 8) | (buf[10] << 16) |
                 (static_cast<size_t>(buf[11]) << 24);
    header_off = 12;
  }
  if (header_off + header_len > size) return false;
  std::string header(reinterpret_cast<const char*>(buf + header_off),
                     header_len);
  if (header.find("'fortran_order': False") == std::string::npos)
    return false;
  if (header.find("'<f4'") != std::string::npos) {
    r->is_f32 = true;
  } else if (header.find("'|u1'") != std::string::npos) {
    r->is_f32 = false;
  } else {
    return false;
  }
  size_t sh = header.find("'shape': (");
  if (sh == std::string::npos) return false;
  sh += 10;
  int nd = 0;
  while (nd < 4 && sh < header.size()) {
    char* end = nullptr;
    long long v = std::strtoll(header.c_str() + sh, &end, 10);
    if (end == header.c_str() + sh) break;
    r->dims[nd++] = v;
    sh = end - header.c_str();
    while (sh < header.size() &&
           (header[sh] == ',' || header[sh] == ' '))
      sh++;
    if (sh < header.size() && header[sh] == ')') break;
  }
  if (nd != 4) return false;
  r->data = buf + header_off + header_len;
  return true;
}

void gather_one(const Reader& r, int32_t idx, int32_t oy, int32_t ox,
                int32_t flip, int p, float scale, float shift,
                float* out) {
  const int64_t c = r.c(), w = r.w();
  const int64_t img_stride = r.h() * w * c;
  const int64_t row_stride = w * c;
  for (int y = 0; y < p; ++y) {
    const uint8_t* row8 =
        r.data + (idx * img_stride + (oy + y) * row_stride + ox * c) *
                     r.item_size();
    float* out_row = out + static_cast<int64_t>(y) * p * c;
    if (!flip) {
      if (r.is_f32) {
        const float* row = reinterpret_cast<const float*>(row8);
        for (int64_t i = 0; i < p * c; ++i)
          out_row[i] = row[i] * scale + shift;
      } else {
        for (int64_t i = 0; i < p * c; ++i)
          out_row[i] = static_cast<float>(row8[i]) * scale + shift;
      }
    } else {
      // horizontal flip: reverse pixel order, keep channel order
      for (int x = 0; x < p; ++x) {
        const int64_t src = static_cast<int64_t>(p - 1 - x) * c;
        for (int64_t ch = 0; ch < c; ++ch) {
          float v = r.is_f32
                        ? reinterpret_cast<const float*>(row8)[src + ch]
                        : static_cast<float>(row8[src + ch]);
          out_row[static_cast<int64_t>(x) * c + ch] = v * scale + shift;
        }
      }
    }
  }
}

// Raw uint8 crop gather: no scale/shift, no float expansion — row
// memcpys (or per-pixel copies under horizontal flip). This is the
// transfer-lean path for the remote-device host tier: streaming crops
// as u8 and normalizing in the device graph cuts host->device bytes 4x
// vs float32 (the tier is input-bound; BASELINE.md round 3).
void gather_one_u8(const Reader& r, int32_t idx, int32_t oy, int32_t ox,
                   int32_t flip, int p, uint8_t* out) {
  const int64_t c = r.c(), w = r.w();
  const int64_t img_stride = r.h() * w * c;
  const int64_t row_stride = w * c;
  for (int y = 0; y < p; ++y) {
    const uint8_t* row8 =
        r.data + idx * img_stride + (oy + y) * row_stride + ox * c;
    uint8_t* out_row = out + static_cast<int64_t>(y) * p * c;
    if (!flip) {
      std::memcpy(out_row, row8, static_cast<size_t>(p) * c);
    } else {
      for (int x = 0; x < p; ++x)
        std::memcpy(out_row + static_cast<int64_t>(x) * c,
                    row8 + static_cast<int64_t>(p - 1 - x) * c, c);
    }
  }
}

struct Prefetcher {
  const Reader* reader;
  int batch, patch;
  float scale, shift;
  bool out_u8 = false;  // emit raw uint8 crops (u8 readers only)
  size_t queue_depth;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  struct Item {
    std::vector<uint8_t> data;  // f32 batches stored as raw bytes
    std::vector<int32_t> indices;
    std::vector<int32_t> offsets;  // [B, 2] (oy, ox)
    std::vector<int32_t> flips;
  };
  std::deque<Item> queue;
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> seq{0};

  size_t item_bytes() const {
    return static_cast<size_t>(batch) * patch * patch * reader->c() *
           (out_u8 ? 1 : sizeof(float));
  }

  void worker(uint64_t seed) {
    std::mt19937_64 rng(seed);
    const int64_t n = reader->n();
    const int64_t max_oy = reader->h() - patch;
    const int64_t max_ox = reader->w() - patch;
    const int64_t c = reader->c();
    while (!stop.load()) {
      Item item;
      item.data.resize(item_bytes());
      item.indices.resize(batch);
      item.offsets.resize(2 * batch);
      item.flips.resize(batch);
      for (int b = 0; b < batch; ++b) {
        int32_t idx = static_cast<int32_t>(rng() % n);
        int32_t oy = static_cast<int32_t>(rng() % (max_oy + 1));
        int32_t ox = static_cast<int32_t>(rng() % (max_ox + 1));
        int32_t flip = static_cast<int32_t>(rng() & 1);
        item.indices[b] = idx;
        item.offsets[2 * b] = oy;
        item.offsets[2 * b + 1] = ox;
        item.flips[b] = flip;
        const size_t el = static_cast<size_t>(b) * patch * patch * c;
        if (out_u8) {
          gather_one_u8(*reader, idx, oy, ox, flip, patch,
                        item.data.data() + el);
        } else {
          gather_one(*reader, idx, oy, ox, flip, patch, scale, shift,
                     reinterpret_cast<float*>(item.data.data()) + el);
        }
      }
      std::unique_lock<std::mutex> lock(mu);
      cv_push.wait(lock, [&] {
        return stop.load() || queue.size() < queue_depth;
      });
      if (stop.load()) return;
      queue.push_back(std::move(item));
      cv_pop.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* sg_open_npy(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  ::close(fd);
  if (map == MAP_FAILED) return nullptr;
  auto* r = new Reader();
  r->map = map;
  r->map_size = st.st_size;
  if (!parse_npy(static_cast<const uint8_t*>(map), st.st_size, r)) {
    munmap(map, st.st_size);
    delete r;
    return nullptr;
  }
  // Sequential-ish access with random starts; let the kernel know.
  madvise(map, st.st_size, MADV_WILLNEED);
  return r;
}

void sg_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  if (!r) return;
  munmap(r->map, r->map_size);
  delete r;
}

int sg_ndim(void* handle) { return 4; }

void sg_shape(void* handle, int64_t* dims_out) {
  auto* r = static_cast<Reader*>(handle);
  for (int i = 0; i < 4; ++i) dims_out[i] = r->dims[i];
}

int sg_is_float32(void* handle) {
  return static_cast<Reader*>(handle)->is_f32 ? 1 : 0;
}

// Synchronous batched crop gather (out: [B, P, P, C] float32).
void sg_gather_crops(void* handle, const int32_t* indices,
                     const int32_t* offsets, const int32_t* flips,
                     int batch, int patch, float scale, float shift,
                     float* out) {
  auto* r = static_cast<Reader*>(handle);
  const int64_t c = r->c();
  for (int b = 0; b < batch; ++b) {
    gather_one(*r, indices[b], offsets[2 * b], offsets[2 * b + 1],
               flips ? flips[b] : 0, patch, scale, shift,
               out + static_cast<size_t>(b) * patch * patch * c);
  }
}

void* sg_prefetcher_create(void* reader_handle, int batch, int patch,
                           float scale, float shift, int queue_depth,
                           int num_threads, uint64_t seed) {
  auto* r = static_cast<Reader*>(reader_handle);
  if (r->h() < patch || r->w() < patch || r->n() == 0) return nullptr;
  auto* pf = new Prefetcher();
  pf->reader = r;
  pf->batch = batch;
  pf->patch = patch;
  pf->scale = scale;
  pf->shift = shift;
  pf->queue_depth = queue_depth;
  for (int t = 0; t < num_threads; ++t)
    pf->workers.emplace_back(&Prefetcher::worker, pf,
                             seed * 2654435761u + t);
  return pf;
}

// uint8-output prefetcher (u8 readers only): batches come out as raw
// [B, P, P, C] uint8 crops — 4x fewer bytes over the host->device
// boundary; normalization happens in the device graph.
void* sg_prefetcher_create_u8(void* reader_handle, int batch, int patch,
                              int queue_depth, int num_threads,
                              uint64_t seed) {
  auto* r = static_cast<Reader*>(reader_handle);
  if (r->is_f32) return nullptr;  // raw-byte output needs a u8 store
  auto* pf = static_cast<Prefetcher*>(sg_prefetcher_create(
      reader_handle, batch, patch, 1.0f, 0.0f, queue_depth, 0, seed));
  if (!pf) return nullptr;
  // Workers start AFTER the flag flips (created with 0 threads above)
  // so no batch is ever gathered with the wrong output dtype.
  pf->out_u8 = true;
  for (int t = 0; t < num_threads; ++t)
    pf->workers.emplace_back(&Prefetcher::worker, pf,
                             seed * 2654435761u + t);
  return pf;
}

// Blocks until a batch is ready; copies into caller buffers.
// out: [B, P, P, C] float32; indices_out/offsets_out/flips_out optional
// ([B], [B,2], [B] int32) — exposed so a caller can gather the matching
// label crops (e.g. density maps) with identical augmentation.
int sg_prefetcher_next(void* pf_handle, void* out, int32_t* indices_out,
                       int32_t* offsets_out, int32_t* flips_out) {
  auto* pf = static_cast<Prefetcher*>(pf_handle);
  Prefetcher::Item item;
  {
    std::unique_lock<std::mutex> lock(pf->mu);
    pf->cv_pop.wait(lock,
                    [&] { return pf->stop.load() || !pf->queue.empty(); });
    if (pf->stop.load() && pf->queue.empty()) return 0;
    item = std::move(pf->queue.front());
    pf->queue.pop_front();
    pf->cv_push.notify_one();
  }
  // item.data holds raw bytes of the configured output dtype (f32 or
  // u8); the caller's buffer matches the dtype it created the
  // prefetcher with.
  std::memcpy(out, item.data.data(), item.data.size());
  if (indices_out)
    std::memcpy(indices_out, item.indices.data(),
                item.indices.size() * sizeof(int32_t));
  if (offsets_out)
    std::memcpy(offsets_out, item.offsets.data(),
                item.offsets.size() * sizeof(int32_t));
  if (flips_out)
    std::memcpy(flips_out, item.flips.data(),
                item.flips.size() * sizeof(int32_t));
  return 1;
}

void sg_prefetcher_destroy(void* pf_handle) {
  auto* pf = static_cast<Prefetcher*>(pf_handle);
  if (!pf) return;
  pf->stop.store(true);
  pf->cv_push.notify_all();
  pf->cv_pop.notify_all();
  for (auto& t : pf->workers) t.join();
  delete pf;
}

}  // extern "C"
