// vloam_tpu native host runtime: KITTI frame IO + async prefetch pipeline.
//
// The reference's IO path is C++ too (rosbag replay + pcl::fromROSMsg +
// cv_bridge, vloam_main_node.cpp:147-164); here the equivalent is a small
// dependency-free shared library the Python driver binds via ctypes:
//
//   * load_bin          — velodyne .bin reader (xyzr float32 -> xyz), the
//                         semantics of point_cloud_util.cpp:148-176
//   * load_png_gray     — 8/16-bit grayscale PNG decode via libpng
//   * prefetcher        — a background thread pool that reads + pads frames
//                         ahead of the device step so host IO overlaps device
//                         compute (double-buffered frame queue)
//
// Build: native/build.sh  ->  native/libvloam_host.so

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <png.h>

extern "C" {

// ---------------------------------------------------------------------------
// Velodyne .bin
// ---------------------------------------------------------------------------

// Reads a KITTI velodyne .bin (N x [x y z reflectance] float32).  Writes up
// to max_points xyz triplets into out (row-major) and returns the number of
// points written, or -1 on IO failure.
int vh_load_bin(const char* path, float* out, int max_points) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  int n = 0;
  float buf[4];
  while (n < max_points && std::fread(buf, sizeof(float), 4, f) == 4) {
    out[3 * n + 0] = buf[0];
    out[3 * n + 1] = buf[1];
    out[3 * n + 2] = buf[2];
    ++n;
  }
  std::fclose(f);
  return n;
}

// ---------------------------------------------------------------------------
// Ring gridding (the data-layer half of scan registration)
// ---------------------------------------------------------------------------

// Ring-grids a raw cloud (n x stride float32, xyz in the first 3) into the
// dense (n_scans, ring_cap, 4) xyzw grid consumed by
// ops.scan_registration.extract_features_from_grid.  Mirrors
// vloam_tpu/data/gridding.py (itself pinned against the device oracle):
// ring id from vertical angle (scan_registration.cpp:217-254), azimuth
// relative time (:185-294), min-range/NaN filter (:107-141), scan-order rank
// within ring.  Returns total gridded points, or -1 on bad n_scans.
int vh_grid_cloud(const float* pts, int n, int stride, int n_scans, int ring_cap,
                  float min_range, float scan_period,
                  float* grid_out, unsigned char* mask_out, int* n_per_ring_out) {
  if (n_scans != 16 && n_scans != 32 && n_scans != 64) return -1;
  const double PI = 3.14159265358979323846;
  std::memset(grid_out, 0, sizeof(float) * (size_t)n_scans * ring_cap * 4);
  std::memset(mask_out, 0, (size_t)n_scans * ring_cap);
  std::memset(n_per_ring_out, 0, sizeof(int) * n_scans);

  std::vector<int> ring(n, -1);
  std::vector<float> ori(n, 0.0f);
  int first = -1, last = -1;
  for (int i = 0; i < n; ++i) {
    float x = pts[i * stride], y = pts[i * stride + 1], z = pts[i * stride + 2];
    if (!(std::isfinite(x) && std::isfinite(y) && std::isfinite(z))) continue;
    float r = std::sqrt(x * x + y * y + z * z);
    if (r < min_range) continue;
    float horiz = std::sqrt(x * x + y * y);
    float angle = (float)(std::atan2((double)z, std::max((double)horiz, 1e-12)) * 180.0 / PI);
    int sid;
    bool ok;
    if (n_scans == 16) {
      sid = (int)((angle + 15.0f) / 2.0f + 0.5f);
      ok = sid >= 0 && sid <= n_scans - 1;
    } else if (n_scans == 32) {
      sid = (int)((angle + 92.0f / 3.0f) * 3.0f / 4.0f);
      ok = sid >= 0 && sid <= n_scans - 1;
    } else {
      if (angle >= -8.83f)
        sid = (int)((2.0f - angle) * 3.0f + 0.5f);
      else
        sid = n_scans / 2 + (int)((-8.83f - angle) * 2.0f + 0.5f);
      ok = angle <= 2.0f && angle >= -24.33f && sid >= 0 && sid <= 50;
    }
    if (!ok) continue;
    ring[i] = sid < 0 ? 0 : (sid > n_scans - 1 ? n_scans - 1 : sid);
    ori[i] = (float)(-std::atan2((double)y, (double)x));
    if (first < 0) first = i;
    last = i;
  }
  double start = 0.0, sweep = 1.0;
  if (first >= 0) {
    start = ori[first];
    double end = ori[last] + 2.0 * PI;
    if (end - start > 3.0 * PI)
      end -= 2.0 * PI;
    else if (end - start < PI)
      end += 2.0 * PI;
    sweep = std::max(end - start, 1e-6);
  }
  int total = 0;
  for (int i = 0; i < n; ++i) {
    if (ring[i] < 0) continue;
    int rr = ring[i];
    int rank = n_per_ring_out[rr];
    if (rank >= ring_cap) continue;
    double rel = std::fmod((double)ori[i] - start, 2.0 * PI);
    if (rel < 0) rel += 2.0 * PI;
    rel /= sweep;
    rel = rel < 0.0 ? 0.0 : (rel > 1.0 ? 1.0 : rel);
    float* cell = grid_out + (((size_t)rr * ring_cap) + rank) * 4;
    cell[0] = pts[i * stride];
    cell[1] = pts[i * stride + 1];
    cell[2] = pts[i * stride + 2];
    cell[3] = (float)rr + scan_period * (float)rel;
    mask_out[(size_t)rr * ring_cap + rank] = 1;
    n_per_ring_out[rr] = rank + 1;
    ++total;
  }
  return total;
}

// ---------------------------------------------------------------------------
// Less-flat voxel run table (the data-layer half of the voxel reduction)
// ---------------------------------------------------------------------------

// C++ twin of vloam_tpu/data/gridding.less_flat_voxel_table (pinned against
// the device oracle ops.voxel.voxel_downsample(presorted, group_key=ring)):
// quantise valid ring-grid cells to voxel keys (p_min rebase, clip to
// max_grid), find consecutive same-(key, ring) runs in flat grid order, and
// accumulate per-run sums of xyzw plus a count column.  The device then only
// subtracts the edge-labeled cells.  grid is (R*C, 4) float32 xyzw, mask
// (R*C) uint8.  Outputs: slot_out (R*C) int32 (-1 invalid/overflow),
// base_out (cap * 5) float32.  Returns the number of runs (<= cap).
int vh_lf_voxel_table(const float* grid, const unsigned char* mask, int R, int C,
                      float leaf, int cap, int max_grid,
                      int* slot_out, float* base_out) {
  const int n = R * C;
  float pmin[3] = {1e30f, 1e30f, 1e30f};
  for (int i = 0; i < n; ++i) {
    if (!mask[i]) continue;
    for (int d = 0; d < 3; ++d) pmin[d] = std::min(pmin[d], grid[i * 4 + d]);
  }
  std::memset(base_out, 0, sizeof(float) * (size_t)cap * 5);
  long long prev_key = -1;
  int prev_ring = -1, run = -1;
  const float inv = 1.0f / leaf;
  for (int i = 0; i < n; ++i) {
    if (!mask[i]) {
      slot_out[i] = -1;
      prev_key = -1;  // invalid rows break runs (key -> INT_MAX in the oracle)
      continue;
    }
    const int ring = i / C;
    long long key = 0;
    for (int d = 0; d < 3; ++d) {
      int q = (int)std::floor((grid[i * 4 + d] - pmin[d]) * inv);
      q = q < 0 ? 0 : (q >= max_grid ? max_grid - 1 : q);
      key += (long long)q << (d * 10);  // max_grid <= 1024 = 2^10
    }
    if (key != prev_key || ring != prev_ring) {
      ++run;
      prev_key = key;
      prev_ring = ring;
    }
    if (run < cap) {
      slot_out[i] = run;
      float* b = base_out + (size_t)run * 5;
      for (int d = 0; d < 4; ++d) b[d] += grid[i * 4 + d];
      b[4] += 1.0f;
    } else {
      slot_out[i] = -1;
    }
  }
  return run + 1 > cap ? cap : run + 1;
}

// ---------------------------------------------------------------------------
// Lidar -> camera depth buckets (the data-layer half of VO depth association)
// ---------------------------------------------------------------------------

// C++ twin of vloam_tpu/data/gridding.depth_buckets (itself pinned against
// the device oracle ops.depth_map.{project_cloud, build_buckets}; semantics
// of point_cloud_util.cpp:183-324): project the cloud through the (3, 4)
// matrix proj = P_rect0 @ rect0_T_cam @ cam_T_velo, average hits into the
// (bw, bh) pixel-bucket grid.  pts is n x stride float32 with xyz first;
// mask may be null (all valid).  Outputs are 4 (bw * bh) float32 planes
// (mean u, mean v, mean z, count).  Returns the number of bucketed points.
int vh_depth_buckets(const float* pts, const unsigned char* mask, int n, int stride,
                     const float* proj, int grid_px, int bw, int bh,
                     float min_depth, float* u_out, float* v_out, float* z_out,
                     float* cnt_out) {
  const size_t nb = (size_t)bw * bh;
  std::memset(u_out, 0, sizeof(float) * nb);
  std::memset(v_out, 0, sizeof(float) * nb);
  std::memset(z_out, 0, sizeof(float) * nb);
  std::memset(cnt_out, 0, sizeof(float) * nb);
  int total = 0;
  for (int i = 0; i < n; ++i) {
    if (mask && !mask[i]) continue;
    const float x = pts[i * stride], y = pts[i * stride + 1], zc = pts[i * stride + 2];
    const float pu = proj[0] * x + proj[1] * y + proj[2] * zc + proj[3];
    const float pv = proj[4] * x + proj[5] * y + proj[6] * zc + proj[7];
    const float pz = proj[8] * x + proj[9] * y + proj[10] * zc + proj[11];
    if (!(pz > min_depth)) continue;
    const float zs = pz > 1e-6f ? pz : 1e-6f;
    const float u = pu / zs, v = pv / zs;
    if (u < 0.0f || v < 0.0f) continue;
    const int ix = (int)(u / grid_px), iy = (int)(v / grid_px);
    if (ix < 0 || ix >= bw || iy < 0 || iy >= bh) continue;
    const size_t b = (size_t)ix * bh + iy;
    u_out[b] += u;
    v_out[b] += v;
    z_out[b] += pz;
    cnt_out[b] += 1.0f;
    ++total;
  }
  for (size_t b = 0; b < nb; ++b) {
    const float c = cnt_out[b] > 1.0f ? cnt_out[b] : 1.0f;
    u_out[b] /= c;
    v_out[b] /= c;
    z_out[b] /= c;
  }
  return total;
}

// ---------------------------------------------------------------------------
// Grayscale PNG
// ---------------------------------------------------------------------------

// Decodes a grayscale (or RGB -> luma) PNG into out (height*width float32,
// 0..255), top-left origin, cropped/zero-padded to (height, width).
// Returns 0 on success.
int vh_load_png_gray(const char* path, float* out, int height, int width) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  png_byte header[8];
  if (std::fread(header, 1, 8, f) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(f);
    return -2;
  }
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(f);
    return -3;
  }
  png_init_io(png, f);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
      color == PNG_COLOR_TYPE_PALETTE)
    png_set_rgb_to_gray_fixed(png, 1, -1, -1);
  png_read_update_info(png, info);

  std::vector<png_byte> row(png_get_rowbytes(png, info));
  std::memset(out, 0, sizeof(float) * height * width);
  for (png_uint_32 y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    if ((int)y >= height) continue;
    png_uint_32 wcopy = w < (png_uint_32)width ? w : (png_uint_32)width;
    for (png_uint_32 x = 0; x < wcopy; ++x) out[y * width + x] = (float)row[x];
  }
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// Async frame prefetcher
// ---------------------------------------------------------------------------

struct Frame {
  std::vector<float> cloud;  // max_points * 3, zero-padded
  int n_points = 0;
  std::vector<float> image;  // height * width (empty if no image)
  // gridded outputs (when the prefetcher was created with n_scans > 0)
  std::vector<float> grid;          // n_scans * ring_cap * 4
  std::vector<unsigned char> gmask; // n_scans * ring_cap
  std::vector<int> n_per_ring;      // n_scans
  int status = 0;
  int index = 0;
};

struct Prefetcher {
  std::vector<std::string> bins;
  std::vector<std::string> pngs;  // empty strings when lidar-only
  int max_points, height, width, depth;
  // ring-gridding config (n_scans == 0 disables gridding)
  int n_scans = 0, ring_cap = 0;
  float min_range = 0.0f, scan_period = 0.1f;
  std::atomic<int> next_submit{0};
  int next_emit = 0;
  std::mutex mu;
  std::condition_variable cv;
  std::deque<Frame> ready;  // ordered by completion; emitted in index order
  std::vector<Frame> done;  // index-keyed completed frames
  std::vector<bool> done_set;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void worker() {
    for (;;) {
      if (stop.load()) return;
      int i = next_submit.fetch_add(1);
      if (i >= (int)bins.size()) return;
      // backpressure: stay at most `depth` frames ahead of the consumer
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return stop.load() || i < next_emit + depth; });
        if (stop.load()) return;
      }
      Frame fr;
      fr.index = i;
      fr.cloud.assign((size_t)max_points * 3, 0.0f);
      fr.n_points = vh_load_bin(bins[i].c_str(), fr.cloud.data(), max_points);
      if (fr.n_points < 0) fr.status = -1;
      if (n_scans > 0 && fr.n_points >= 0) {
        fr.grid.assign((size_t)n_scans * ring_cap * 4, 0.0f);
        fr.gmask.assign((size_t)n_scans * ring_cap, 0);
        fr.n_per_ring.assign(n_scans, 0);
        vh_grid_cloud(fr.cloud.data(), fr.n_points, 3, n_scans, ring_cap,
                      min_range, scan_period, fr.grid.data(), fr.gmask.data(),
                      fr.n_per_ring.data());
      }
      if (!pngs[i].empty()) {
        fr.image.assign((size_t)height * width, 0.0f);
        if (vh_load_png_gray(pngs[i].c_str(), fr.image.data(), height, width) != 0)
          fr.status = -2;
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        done[i] = std::move(fr);
        done_set[i] = true;
      }
      cv.notify_all();
    }
  }
};

// paths: '\n'-joined bin paths; img_paths likewise ('\n'-joined, empty lines
// for lidar-only frames) or nullptr.
void* vh_prefetcher_create(const char* bin_paths, const char* img_paths, int max_points,
                           int height, int width, int depth, int n_threads,
                           int n_scans, int ring_cap, float min_range, float scan_period) {
  auto split = [](const char* s) {
    std::vector<std::string> out;
    if (!s) return out;
    const char* p = s;
    while (*p) {
      const char* e = std::strchr(p, '\n');
      if (!e) {
        out.emplace_back(p);
        break;
      }
      out.emplace_back(p, e - p);
      p = e + 1;
    }
    return out;
  };
  auto* pf = new Prefetcher();
  pf->bins = split(bin_paths);
  pf->pngs = split(img_paths);
  pf->pngs.resize(pf->bins.size());
  pf->max_points = max_points;
  pf->height = height;
  pf->width = width;
  pf->depth = depth < 1 ? 2 : depth;
  pf->n_scans = n_scans;
  pf->ring_cap = ring_cap;
  pf->min_range = min_range;
  pf->scan_period = scan_period;
  pf->done.resize(pf->bins.size());
  pf->done_set.assign(pf->bins.size(), false);
  int nt = n_threads < 1 ? 2 : n_threads;
  for (int t = 0; t < nt; ++t) pf->workers.emplace_back([pf] { pf->worker(); });
  return pf;
}

int vh_prefetcher_len(void* handle) { return (int)((Prefetcher*)handle)->bins.size(); }

// Blocks until the next frame (in order) is loaded; copies it out.
// Returns n_points (>=0) or the frame's error status (<0); -99 when past the end.
int vh_prefetcher_next(void* handle, float* cloud_out, float* image_out) {
  auto* pf = (Prefetcher*)handle;
  int i = pf->next_emit;
  if (i >= (int)pf->bins.size()) return -99;
  std::unique_lock<std::mutex> lk(pf->mu);
  pf->cv.wait(lk, [&] { return pf->done_set[i]; });
  Frame& fr = pf->done[i];
  std::memcpy(cloud_out, fr.cloud.data(), sizeof(float) * (size_t)pf->max_points * 3);
  if (image_out && !fr.image.empty())
    std::memcpy(image_out, fr.image.data(), sizeof(float) * (size_t)pf->height * pf->width);
  int rc = fr.status < 0 ? fr.status : fr.n_points;
  fr = Frame();  // release memory
  pf->next_emit = i + 1;
  lk.unlock();
  pf->cv.notify_all();
  return rc;
}

// Grid-mode variant: copies the ring grid built by the worker threads.
// Requires the prefetcher to have been created with n_scans > 0.
int vh_prefetcher_next_grid(void* handle, float* grid_out, unsigned char* mask_out,
                            int* n_per_ring_out, float* image_out) {
  auto* pf = (Prefetcher*)handle;
  int i = pf->next_emit;
  if (i >= (int)pf->bins.size()) return -99;
  if (pf->n_scans <= 0) return -98;
  std::unique_lock<std::mutex> lk(pf->mu);
  pf->cv.wait(lk, [&] { return pf->done_set[i]; });
  Frame& fr = pf->done[i];
  if (!fr.grid.empty()) {
    std::memcpy(grid_out, fr.grid.data(),
                sizeof(float) * (size_t)pf->n_scans * pf->ring_cap * 4);
    std::memcpy(mask_out, fr.gmask.data(), (size_t)pf->n_scans * pf->ring_cap);
    std::memcpy(n_per_ring_out, fr.n_per_ring.data(), sizeof(int) * pf->n_scans);
  }
  if (image_out && !fr.image.empty())
    std::memcpy(image_out, fr.image.data(), sizeof(float) * (size_t)pf->height * pf->width);
  int rc = fr.status < 0 ? fr.status : fr.n_points;
  fr = Frame();
  pf->next_emit = i + 1;
  lk.unlock();
  pf->cv.notify_all();
  return rc;
}

void vh_prefetcher_destroy(void* handle) {
  auto* pf = (Prefetcher*)handle;
  pf->stop.store(true);
  pf->cv.notify_all();
  for (auto& t : pf->workers) t.join();
  delete pf;
}

}  // extern "C"
