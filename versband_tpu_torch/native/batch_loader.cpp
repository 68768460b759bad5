// Native batch loader: parallel .npy mel reads assembled into one padded
// batch buffer.
//
// The hot host-side work in training is: load B mel files [C, T_i] (float32
// .npy), crop/pad each to T frames, and stack into [B, C, T]. Python does
// this through np.load + np.pad per item under the GIL; this loader mmaps
// each file, parses the npy header, and copies rows directly into the
// caller's preallocated batch buffer from a thread pool — zero Python-object
// traffic, page-cache friendly.
//
// Exposed C ABI (ctypes, see native/__init__.py):
//   int vb_load_mel_batch(const char** paths, int n_items,
//                         const long* starts,      // crop start per item (frames)
//                         int channels, int t_target, float pad_value,
//                         float* out,              // [n_items, channels, t_target]
//                         long* lengths,           // out: valid frames per item
//                         int num_threads);
// Returns the number of successfully loaded items; failed items are filled
// with pad_value and lengths[i] = -1 (the Python side applies its
// corrupted-file fallback semantics).
//
// Build: versband_tpu_torch/native/__init__.py::ensure_built (g++ -O3 -std=c++17
// -shared -fPIC ... -lpthread, into build/versband_tpu_torch/native/<hash>/).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct NpyInfo {
  const float* data = nullptr;  // points into the mapping
  long rows = 0;                // C
  long cols = 0;                // T_i
  void* map = nullptr;
  size_t map_len = 0;
  bool ok = false;
};

// Minimal .npy v1/v2 header parser for little-endian float32 C-order arrays.
NpyInfo map_npy(const char* path) {
  NpyInfo info;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return info;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 16) { close(fd); return info; }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (map == MAP_FAILED) return info;
  const unsigned char* p = static_cast<const unsigned char*>(map);
  if (memcmp(p, "\x93NUMPY", 6) != 0) { munmap(map, st.st_size); return info; }
  int major = p[6];
  size_t header_len, header_off;
  if (major == 1) {
    header_len = p[8] | (p[9] << 8);
    header_off = 10;
  } else {
    header_len = p[8] | (p[9] << 8) | (size_t(p[10]) << 16) | (size_t(p[11]) << 24);
    header_off = 12;
  }
  // Bound-check the declared header against the real file size BEFORE
  // touching it: a truncated/corrupted file must fall into the caller's
  // lengths[i] = -1 fallback, not read out of the mapping.
  const size_t file_size = (size_t)st.st_size;
  if (header_len > file_size || header_off > file_size - header_len) {
    munmap(map, st.st_size);
    return info;
  }
  std::string header(reinterpret_cast<const char*>(p + header_off), header_len);
  if (header.find("'<f4'") == std::string::npos ||
      header.find("'fortran_order': False") == std::string::npos) {
    munmap(map, st.st_size);
    return info;
  }
  size_t sp = header.find("'shape': (");
  if (sp == std::string::npos) { munmap(map, st.st_size); return info; }
  long rows = 0, cols = 0;
  if (sscanf(header.c_str() + sp, "'shape': (%ld, %ld)", &rows, &cols) != 2 ||
      rows < 0 || cols < 0) {
    munmap(map, st.st_size);
    return info;
  }
  // Overflow-safe payload bound: hostile headers could make rows*cols*4 wrap.
  const size_t avail = file_size - header_off - header_len;
  const size_t urows = (size_t)rows, ucols = (size_t)cols;
  if (urows != 0 &&
      (ucols > SIZE_MAX / urows || urows * ucols > avail / sizeof(float))) {
    munmap(map, st.st_size);
    return info;
  }
  info.data = reinterpret_cast<const float*>(p + header_off + header_len);
  info.rows = rows;
  info.cols = cols;
  info.map = map;
  info.map_len = st.st_size;
  info.ok = true;
  return info;
}

}  // namespace

extern "C" int vb_load_mel_batch(const char** paths, int n_items,
                                 const long* starts, int channels,
                                 int t_target, float pad_value, float* out,
                                 long* lengths, int num_threads) {
  std::atomic<int> ok_count{0};
  std::atomic<int> next{0};
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_items) return;
      float* dst = out + (size_t)i * channels * t_target;
      NpyInfo info = map_npy(paths[i]);
      if (!info.ok || info.rows < channels) {
        for (long j = 0; j < (long)channels * t_target; ++j) dst[j] = pad_value;
        lengths[i] = -1;
        if (info.map) munmap(info.map, info.map_len);
        continue;
      }
      long start = starts ? starts[i] : 0;
      if (start < 0) start = 0;
      if (start > info.cols) start = info.cols;
      long valid = info.cols - start;
      if (valid > t_target) valid = t_target;
      for (int c = 0; c < channels; ++c) {
        const float* src = info.data + (size_t)c * info.cols + start;
        float* row = dst + (size_t)c * t_target;
        memcpy(row, src, valid * sizeof(float));
        for (long j = valid; j < t_target; ++j) row[j] = pad_value;
      }
      lengths[i] = valid;
      ok_count.fetch_add(1);
      munmap(info.map, info.map_len);
    }
  };
  int nt = num_threads > 0 ? num_threads : 1;
  if (nt > n_items) nt = n_items;
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
  return ok_count.load();
}
