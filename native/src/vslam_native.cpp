// vslam_native: host-side runtime support for the SLAM framework.
//
// The reference is a C++ system throughout; in the array-program redesign the
// compute path is JAX/XLA, and this library provides the native runtime
// around it (the role the reference's srrg_core txt_io playback + OpenCV
// imread pipeline played, slam_assembly.cpp:343-492):
//
//   * a PNG (zlib) / PGM image decoder for the dataset formats the loaders
//     consume (KITTI/EuRoC/TUM ship 8/16-bit grayscale PNGs),
//   * a threaded look-ahead prefetcher that decodes frames on background
//     threads into a bounded in-order queue so host decode overlaps device
//     compute (the "pipelined frame processing" component, SURVEY.md §2.9),
//   * union-find over landmark-merge pairs (the hot part of
//     WorldMap::mergeLandmarks, world_map.cpp:305-478).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this environment).

#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

// ---------------------------------------------------------------------------
// Image decoding
// ---------------------------------------------------------------------------

struct Image {
  int h = 0, w = 0, bytes_per_px = 0;  // 1 = gray8, 2 = gray16
  std::vector<uint8_t> data;           // row-major, gray16 little-endian
  bool ok = false;
};

static bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out.resize(n);
  size_t got = fread(out.data(), 1, n, f);
  fclose(f);
  return got == static_cast<size_t>(n);
}

static uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) |
         uint32_t(p[3]);
}

static int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Decode non-interlaced PNG, color types 0 (gray, 8/16 bit) and 2 (RGB8,
// converted to gray8 with the OpenCV BGR2GRAY weights).
static Image decode_png(const std::vector<uint8_t>& buf) {
  Image img;
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (buf.size() < 8 || memcmp(buf.data(), sig, 8) != 0) return img;

  uint32_t w = 0, h = 0;
  int bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;

  size_t pos = 8;
  while (pos + 8 <= buf.size()) {
    uint32_t len = be32(&buf[pos]);
    if (pos + 12 + len > buf.size()) return img;
    const char* type = reinterpret_cast<const char*>(&buf[pos + 4]);
    const uint8_t* data = &buf[pos + 8];
    if (memcmp(type, "IHDR", 4) == 0) {
      w = be32(data);
      h = be32(data + 4);
      bit_depth = data[8];
      color_type = data[9];
      interlace = data[12];
    } else if (memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), data, data + len);
    } else if (memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  if (!w || !h || interlace != 0) return img;
  int channels;
  if (color_type == 0) channels = 1;
  else if (color_type == 2) channels = 3;
  else return img;  // palette/alpha variants unsupported
  if (bit_depth != 8 && bit_depth != 16) return img;
  if (color_type == 2 && bit_depth != 8) return img;

  const int src_bpp = channels * bit_depth / 8;
  const size_t stride = size_t(w) * src_bpp;
  std::vector<uint8_t> raw(h * (stride + 1));
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size())
    return img;

  // Unfilter in place into `flat`.
  std::vector<uint8_t> flat(h * stride);
  for (uint32_t y = 0; y < h; ++y) {
    const uint8_t* src = &raw[y * (stride + 1)];
    uint8_t filter = src[0];
    const uint8_t* line = src + 1;
    uint8_t* dst = &flat[y * stride];
    const uint8_t* prev = y ? &flat[(y - 1) * stride] : nullptr;
    for (size_t x = 0; x < stride; ++x) {
      int a = x >= size_t(src_bpp) ? dst[x - src_bpp] : 0;
      int b = prev ? prev[x] : 0;
      int c = (prev && x >= size_t(src_bpp)) ? prev[x - src_bpp] : 0;
      int v = line[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return img;
      }
      dst[x] = uint8_t(v);
    }
  }

  img.h = h;
  img.w = w;
  if (color_type == 0 && bit_depth == 8) {
    img.bytes_per_px = 1;
    img.data = std::move(flat);
  } else if (color_type == 0 && bit_depth == 16) {
    // PNG 16-bit is big-endian; emit little-endian uint16.
    img.bytes_per_px = 2;
    img.data.resize(size_t(h) * w * 2);
    for (size_t i = 0; i < size_t(h) * w; ++i) {
      img.data[2 * i] = flat[2 * i + 1];
      img.data[2 * i + 1] = flat[2 * i];
    }
  } else {  // RGB8 -> gray8 (OpenCV weights; PNG byte order is R,G,B)
    img.bytes_per_px = 1;
    img.data.resize(size_t(h) * w);
    for (size_t i = 0; i < size_t(h) * w; ++i) {
      int r = flat[3 * i], g = flat[3 * i + 1], b = flat[3 * i + 2];
      img.data[i] = uint8_t((299 * r + 587 * g + 114 * b + 500) / 1000);
    }
  }
  img.ok = true;
  return img;
}

// Decode binary PGM (P5), maxval <= 255 or <= 65535.
static Image decode_pgm(const std::vector<uint8_t>& buf) {
  Image img;
  if (buf.size() < 2 || buf[0] != 'P' || buf[1] != '5') return img;
  size_t pos = 2;
  int fields[3];
  for (int k = 0; k < 3;) {
    while (pos < buf.size() && (isspace(buf[pos]) || buf[pos] == '#')) {
      if (buf[pos] == '#')
        while (pos < buf.size() && buf[pos] != '\n') ++pos;
      else
        ++pos;
    }
    int v = 0;
    bool any = false;
    while (pos < buf.size() && isdigit(buf[pos])) {
      v = v * 10 + (buf[pos++] - '0');
      any = true;
    }
    if (!any) return img;
    fields[k++] = v;
  }
  ++pos;  // single whitespace after maxval
  int w = fields[0], h = fields[1], maxval = fields[2];
  int bpp = maxval > 255 ? 2 : 1;
  size_t need = size_t(w) * h * bpp;
  if (buf.size() - pos < need) return img;
  img.h = h;
  img.w = w;
  img.bytes_per_px = bpp;
  img.data.resize(need);
  if (bpp == 1) {
    memcpy(img.data.data(), &buf[pos], need);
  } else {  // PGM 16-bit is big-endian
    for (size_t i = 0; i < size_t(w) * h; ++i) {
      img.data[2 * i] = buf[pos + 2 * i + 1];
      img.data[2 * i + 1] = buf[pos + 2 * i];
    }
  }
  img.ok = true;
  return img;
}

static Image decode_path(const std::string& path) {
  std::vector<uint8_t> buf;
  if (!read_file(path.c_str(), buf)) return {};
  if (buf.size() >= 8 && buf[0] == 137 && buf[1] == 'P') return decode_png(buf);
  if (buf.size() >= 2 && buf[0] == 'P' && buf[1] == '5') return decode_pgm(buf);
  return {};
}

extern "C" {

// Synchronous decode. Returns 0 on success; fills h/w/bytes_per_px. The
// caller passes a buffer of `cap` bytes; required size is h*w*bytes_per_px.
int vn_decode_image(const char* path, uint8_t* out, int64_t cap, int* h,
                    int* w, int* bytes_per_px) {
  Image img = decode_path(path);
  if (!img.ok) return -1;
  *h = img.h;
  *w = img.w;
  *bytes_per_px = img.bytes_per_px;
  if (int64_t(img.data.size()) > cap) return -2;
  memcpy(out, img.data.data(), img.data.size());
  return 0;
}

// ---------------------------------------------------------------------------
// Threaded look-ahead prefetcher: decodes a fixed list of files on worker
// threads, delivers them strictly in order.
// ---------------------------------------------------------------------------

struct Prefetcher {
  std::vector<std::string> paths;
  std::map<int, Image> ready;  // decoded, waiting for in-order delivery
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::atomic<int> next_to_decode{0};
  int next_to_deliver = 0;
  int look_ahead = 8;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void worker() {
    while (!stop.load()) {
      int idx = next_to_decode.fetch_add(1);
      if (idx >= int(paths.size())) return;
      Image img = decode_path(paths[idx]);
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] {
        return stop.load() || idx < next_to_deliver + look_ahead;
      });
      if (stop.load()) return;
      ready.emplace(idx, std::move(img));
      cv_ready.notify_all();
    }
  }
};

void* vn_prefetcher_create(const char** paths, int n, int n_threads,
                           int look_ahead) {
  auto* p = new Prefetcher();
  p->paths.assign(paths, paths + n);
  p->look_ahead = look_ahead > 0 ? look_ahead : 8;
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; ++i)
    p->workers.emplace_back(&Prefetcher::worker, p);
  return p;
}

// Blocking next-in-order frame. Returns 0 ok, -1 decode failure, -2 buffer
// too small, -3 end of sequence.
int vn_prefetcher_next(void* handle, uint8_t* out, int64_t cap, int* h,
                       int* w, int* bytes_per_px) {
  auto* p = static_cast<Prefetcher*>(handle);
  std::unique_lock<std::mutex> lk(p->mu);
  int idx = p->next_to_deliver;
  if (idx >= int(p->paths.size())) return -3;
  p->cv_ready.wait(lk, [&] { return p->ready.count(idx) > 0; });
  Image img = std::move(p->ready[idx]);
  p->ready.erase(idx);
  p->next_to_deliver++;
  p->cv_space.notify_all();
  lk.unlock();
  if (!img.ok) return -1;
  *h = img.h;
  *w = img.w;
  *bytes_per_px = img.bytes_per_px;
  if (int64_t(img.data.size()) > cap) return -2;
  memcpy(out, img.data.data(), img.data.size());
  return 0;
}

void vn_prefetcher_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  p->stop.store(true);
  p->cv_space.notify_all();
  p->cv_ready.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

// ---------------------------------------------------------------------------
// Union-find over merge pairs (landmark merging).
// pairs: (n, 2) int32.  out_parent: per unique id the representative;
// flattened as [id0, rep0, id1, rep1, ...] into out (capacity 2*max_out).
// Returns the number of (id, rep) entries written (only ids whose
// representative differs from themselves).
// ---------------------------------------------------------------------------

int vn_union_find(const int32_t* pairs, int n, int32_t* out, int max_out) {
  std::map<int32_t, int32_t> parent;
  std::vector<int32_t> stack;
  auto find = [&](int32_t x) {
    stack.clear();
    auto it = parent.find(x);
    while (it != parent.end() && it->second != x) {
      stack.push_back(x);
      x = it->second;
      it = parent.find(x);
    }
    for (int32_t s : stack) parent[s] = x;  // path compression
    return x;
  };
  for (int i = 0; i < n; ++i) {
    int32_t a = pairs[2 * i], b = pairs[2 * i + 1];
    if (a < 0 || b < 0 || a == b) continue;
    parent.emplace(a, a);
    parent.emplace(b, b);
    int32_t ra = find(a), rb = find(b);
    if (ra == rb) continue;
    if (ra > rb) std::swap(ra, rb);  // elder (smaller id) is representative
    parent[rb] = ra;
  }
  int k = 0;
  for (auto& kv : parent) {
    int32_t rep = find(kv.first);
    if (rep != kv.first) {
      if (k >= max_out) return -1;
      out[2 * k] = kv.first;
      out[2 * k + 1] = rep;
      ++k;
    }
  }
  return k;
}

}  // extern "C"
