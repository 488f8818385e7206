// Native threaded batch pipeline (host code, built with g++) — the
// counterpart of the reference's torch DataLoader C++ worker pool (num_workers=4,
// pytorch_cifar10_resnet.py:118,137-148): seeded global shuffle,
// DistributedSampler-style interleaved sharding, augmentation, and a bounded
// ring of pre-filled batch buffers produced by a worker pool so host-side
// data prep overlaps device steps.
//
// Augmentation modes (the reference's torchvision transform stacks):
//   0  none                 — memcpy (plus dtype/normalize when configured)
//   1  pad-crop + flip      — CIFAR transform_train (pad-4 random crop,
//                             horizontal flip; pytorch_cifar10_resnet.py)
//   2  RandomResizedCrop + flip — ImageNet transform_train
//                             (pytorch_imagenet_resnet.py:154-166): random
//                             area in [0.08, 1]·src, log-uniform aspect in
//                             [3/4, 4/3], 10 attempts then center fallback,
//                             bilinear resize to out_h×out_w, flip p=0.5
//   3  Resize + CenterCrop  — ImageNet eval transform
//                             (pytorch_imagenet_resnet.py:180-193): bilinear
//                             resize shorter side to resize_size, center crop
//
// Inputs may be float32 or uint8 (ImageNet shards are uint8 — f32 would be
// 770 GB); outputs are always float32, optionally normalized per channel
// ((x/255 - mean)/std for uint8 inputs, (x - mean)/std for float inputs).
//
// Determinism: the epoch permutation is a Fisher–Yates driven by
// splitmix64(seed), and per-sample augmentation parameters derive from
// (seed, position-in-epoch) — results are byte-identical for any thread
// count. The Python wrapper (kfac_pytorch_tpu_torch/runtime/loader.py) binds
// this via ctypes; build with:  g++ -O3 -shared -fPIC -pthread loader.cpp
//
// C ABI:
//   kl_create(...)            -> opaque loader
//   kl_set_norm(p, mean, std) -> enable per-channel normalization
//   kl_start_epoch(p, seed)   -> shuffle + spawn workers
//   kl_num_batches(p)         -> batches per epoch (per shard)
//   kl_next(p, out_x, out_y)  -> 1 and fills out buffers, or 0 at epoch end
//   kl_destroy(p)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

inline uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

inline double uniform01(uint64_t& s) {
  return double(splitmix64(s) >> 11) * (1.0 / 9007199254740992.0);
}

struct Loader {
  // dataset (borrowed pointers — the Python side keeps the arrays alive)
  const void* x = nullptr;  // float32 or uint8 per in_dtype
  const int32_t* y = nullptr;
  int64_t n = 0;
  int h = 0, w = 0, c = 0;          // stored sample geometry
  int out_h = 0, out_w = 0;         // emitted geometry (mode 2/3 may differ)
  int batch = 0;
  int num_shards = 1, shard_index = 0;
  bool shuffle = false;
  int mode = 0;                     // augmentation mode, see header
  int pad = 4;                      // mode-1 crop padding
  int resize_size = 256;            // mode-3 shorter-side resize
  int in_dtype = 0;                 // 0 = float32, 1 = uint8
  bool normalize = false;
  float mean[3] = {0, 0, 0}, stdev[3] = {1, 1, 1};
  int threads = 4, depth = 4;

  // epoch state
  uint64_t seed = 0;
  std::vector<int64_t> order;  // this shard's sample indices, epoch order
  int64_t n_batches = 0;

  // ring of batch slots
  struct Slot {
    std::vector<float> xs;
    std::vector<int32_t> ys;
    int64_t ready_for = -1;  // batch index this slot holds, -1 = empty
  };
  std::vector<Slot> slots;
  std::atomic<int64_t> next_claim{0};
  int64_t next_consume = 0;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::vector<std::thread> pool;
  bool stopping = false;

  int64_t in_sample_elems() const { return int64_t(h) * w * c; }
  int64_t out_sample_elems() const { return int64_t(out_h) * out_w * c; }

  // ---- pixel access on the stored (source) image, channel-interleaved ----
  inline float load_px(const void* img, int r, int col, int ch) const {
    const int64_t off = (int64_t(r) * w + col) * c + ch;
    if (in_dtype == 1) return float(static_cast<const uint8_t*>(img)[off]) * (1.0f / 255.0f);
    return static_cast<const float*>(img)[off];
  }

  inline float norm_px(float v, int ch) const {
    // mean/stdev hold 3 channels; channels beyond that pass through
    // (the Python binding rejects c != len(mean) up front)
    return (normalize && ch < 3) ? (v - mean[ch]) / stdev[ch] : v;
  }

  const void* sample_ptr(int64_t src) const {
    const int64_t elems = in_sample_elems();
    if (in_dtype == 1) return static_cast<const uint8_t*>(x) + src * elems;
    return static_cast<const float*>(x) + src * elems;
  }

  // Bilinear-sample into the out_h×out_w destination with the
  // align_corners=false (torch/PIL) convention: output pixel (r, col) reads
  // source coordinate ((r+0.5)·sy − 0.5 + oy, (col+0.5)·sx − 0.5 + ox),
  // clamped to [lo, hi] per axis. Covers both transform stacks exactly:
  //   RandomResizedCrop(i, j, h_c, w_c → out):  s = crop/out, o = crop start,
  //     clamp to the crop window (torch resizes the crop, replicating its
  //     edges)
  //   Resize(scale) + CenterCrop(top, left):    s = 1/scale, o = top/scale,
  //     clamp to the full image — mathematically identical to
  //     resize-then-crop since the crop itself never interpolates
  // Optional horizontal flip of the OUTPUT.
  void resize_crop(const void* img, float* dst, double oy, double ox,
                   double sy, double sx, double lo_y, double hi_y,
                   double lo_x, double hi_x, bool flip) const {
    for (int r = 0; r < out_h; r++) {
      double fy = (double(r) + 0.5) * sy - 0.5 + oy;
      fy = std::min(std::max(fy, lo_y), hi_y);
      const int y0 = int(fy);
      const int y1 = std::min(y0 + 1, h - 1);
      const float wy = float(fy - double(y0));
      float* drow = dst + int64_t(r) * out_w * c;
      for (int col = 0; col < out_w; col++) {
        const int oc = flip ? (out_w - 1 - col) : col;
        double fx = (double(col) + 0.5) * sx - 0.5 + ox;
        fx = std::min(std::max(fx, lo_x), hi_x);
        const int x0 = int(fx);
        const int x1 = std::min(x0 + 1, w - 1);
        const float wx = float(fx - double(x0));
        for (int ch = 0; ch < c; ch++) {
          const float p00 = load_px(img, y0, x0, ch);
          const float p01 = load_px(img, y0, x1, ch);
          const float p10 = load_px(img, y1, x0, ch);
          const float p11 = load_px(img, y1, x1, ch);
          const float v = p00 * (1 - wy) * (1 - wx) + p01 * (1 - wy) * wx +
                          p10 * wy * (1 - wx) + p11 * wy * wx;
          drow[int64_t(oc) * c + ch] = norm_px(v, ch);
        }
      }
    }
  }

  // torchvision RandomResizedCrop.get_params (pytorch_imagenet_resnet.py's
  // train transform): 10 attempts of (area, log-aspect) sampling, then the
  // ratio-clamped center-crop fallback.
  void rrc_params(uint64_t& s, int& ci, int& cj, int& ch_c, int& cw_c) const {
    const double area = double(h) * double(w);
    const double lo = std::log(3.0 / 4.0), hi = std::log(4.0 / 3.0);
    for (int attempt = 0; attempt < 10; attempt++) {
      const double target = (0.08 + uniform01(s) * 0.92) * area;
      const double ar = std::exp(lo + uniform01(s) * (hi - lo));
      const int cw = int(std::lround(std::sqrt(target * ar)));
      const int chh = int(std::lround(std::sqrt(target / ar)));
      if (cw > 0 && chh > 0 && cw <= w && chh <= h) {
        ci = (h == chh) ? 0 : int(splitmix64(s) % uint64_t(h - chh + 1));
        cj = (w == cw) ? 0 : int(splitmix64(s) % uint64_t(w - cw + 1));
        ch_c = chh;
        cw_c = cw;
        return;
      }
    }
    // fallback: clamp aspect, center crop
    const double in_ratio = double(w) / double(h);
    int cw, chh;
    if (in_ratio < 3.0 / 4.0) {
      cw = w;
      chh = int(std::lround(double(cw) / (3.0 / 4.0)));
    } else if (in_ratio > 4.0 / 3.0) {
      chh = h;
      cw = int(std::lround(double(chh) * (4.0 / 3.0)));
    } else {
      cw = w;
      chh = h;
    }
    ci = (h - chh) / 2;
    cj = (w - cw) / 2;
    ch_c = chh;
    cw_c = cw;
  }

  void fill_sample_none(const void* img, float* dst) const {
    if (in_dtype == 0 && !normalize) {
      std::memcpy(dst, img, size_t(in_sample_elems()) * sizeof(float));
      return;
    }
    const int64_t px = int64_t(h) * w;
    for (int64_t p = 0; p < px; p++)
      for (int ch = 0; ch < c; ch++)
        dst[p * c + ch] = norm_px(load_px(img, int(p / w), int(p % w), ch), ch);
  }

  void fill_sample_padcrop(const void* img, float* dst, uint64_t& s) const {
    const int side = 2 * pad + 1;
    const uint64_t r = splitmix64(s);
    const int dy = int(r % side) - pad;  // crop offset in [-pad, pad]
    const int dxo = int((r >> 16) % side) - pad;
    const bool flip = ((r >> 32) & 1) != 0;
    for (int row = 0; row < h; row++) {
      const int sr = row + dy;
      float* drow = dst + int64_t(row) * w * c;
      if (sr < 0 || sr >= h) {
        for (int i = 0; i < w * c; i++) drow[i] = norm_px(0.0f, i % c);
        continue;
      }
      for (int col = 0; col < w; col++) {
        const int sc = (flip ? (w - 1 - col) : col) + dxo;
        float* dpix = drow + int64_t(col) * c;
        for (int ch = 0; ch < c; ch++)
          dpix[ch] = (sc < 0 || sc >= w) ? norm_px(0.0f, ch)
                                         : norm_px(load_px(img, sr, sc, ch), ch);
      }
    }
  }

  void fill_sample_rrc(const void* img, float* dst, uint64_t& s) const {
    int ci, cj, ch_c, cw_c;
    rrc_params(s, ci, cj, ch_c, cw_c);
    const bool flip = uniform01(s) < 0.5;
    resize_crop(img, dst,
                /*oy=*/double(ci), /*ox=*/double(cj),
                /*sy=*/double(ch_c) / out_h, /*sx=*/double(cw_c) / out_w,
                /*lo_y=*/double(ci), /*hi_y=*/double(ci + ch_c - 1),
                /*lo_x=*/double(cj), /*hi_x=*/double(cj + cw_c - 1), flip);
  }

  void fill_sample_centercrop(const void* img, float* dst) const {
    // Resize(resize_size) scales the SHORTER side to resize_size (separate
    // per-axis scales because the resized dims are rounded); CenterCrop
    // (out_h, out_w) then selects rows/cols of that resized image. Since
    // the crop never interpolates, a single bilinear pass at the resized
    // scale with the crop start folded into the offset is exact.
    const double scale = double(resize_size) / double(std::min(h, w));
    const int rh = int(std::lround(h * scale)), rw = int(std::lround(w * scale));
    const double sy = double(h) / rh, sx = double(w) / rw;
    const int ty = (rh - out_h) / 2, tx = (rw - out_w) / 2;
    resize_crop(img, dst,
                /*oy=*/(double(ty)) * sy, /*ox=*/(double(tx)) * sx,
                sy, sx,
                /*lo_y=*/0.0, /*hi_y=*/double(h - 1),
                /*lo_x=*/0.0, /*hi_x=*/double(w - 1), /*flip=*/false);
  }

  void fill_batch(int64_t b, float* out_x, int32_t* out_y) {
    const int64_t out_elems = out_sample_elems();
    for (int i = 0; i < batch; i++) {
      const int64_t pos = b * batch + i;  // position in epoch order
      const int64_t src = order[pos];
      out_y[i] = y[src];
      const void* sx = sample_ptr(src);
      float* dx = out_x + int64_t(i) * out_elems;
      uint64_t s =
          seed ^ (0xd1b54a32d192ed03ULL + uint64_t(pos) * 0x9e3779b97f4a7c15ULL);
      switch (mode) {
        case 1: fill_sample_padcrop(sx, dx, s); break;
        case 2: fill_sample_rrc(sx, dx, s); break;
        case 3: fill_sample_centercrop(sx, dx); break;
        default: fill_sample_none(sx, dx); break;
      }
    }
  }

  void worker() {
    for (;;) {
      const int64_t b = next_claim.fetch_add(1);
      if (b >= n_batches) return;
      Slot& slot = slots[b % depth];
      {
        std::unique_lock<std::mutex> lk(mu);
        // wait until the consumer has drained whatever lived in this slot
        cv_free.wait(lk, [&] { return stopping || b - next_consume < depth; });
        if (stopping) return;
      }
      fill_batch(b, slot.xs.data(), slot.ys.data());
      {
        std::lock_guard<std::mutex> lk(mu);
        slot.ready_for = b;
      }
      cv_ready.notify_all();
    }
  }

  void stop_pool() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stopping = true;
    }
    cv_free.notify_all();
    for (auto& t : pool) t.join();
    pool.clear();
    stopping = false;
  }

  void start_epoch(uint64_t s) {
    stop_pool();
    seed = s;
    // same seeded GLOBAL permutation on every host, then this host's
    // interleaved slice (the DistributedSampler pattern); batch count from
    // the minimum shard so all hosts step in lockstep.
    std::vector<int64_t> global(n);
    for (int64_t i = 0; i < n; i++) global[i] = i;
    if (shuffle) {
      uint64_t st = seed ^ 0x2545f4914f6cdd1dULL;
      for (int64_t i = n - 1; i > 0; i--) {
        const int64_t j = int64_t(splitmix64(st) % uint64_t(i + 1));
        std::swap(global[i], global[j]);
      }
    }
    order.clear();
    for (int64_t i = shard_index; i < n; i += num_shards) order.push_back(global[i]);
    n_batches = (n / num_shards) / batch;
    for (auto& slot : slots) slot.ready_for = -1;
    next_claim.store(0);
    next_consume = 0;
    const int nt = std::max(1, threads);
    for (int t = 0; t < nt; t++) pool.emplace_back([this] { worker(); });
  }

  int next(float* out_x, int32_t* out_y) {
    if (next_consume >= n_batches) return 0;
    const int64_t b = next_consume;
    Slot& slot = slots[b % depth];
    {
      std::unique_lock<std::mutex> lk(mu);
      cv_ready.wait(lk, [&] { return slot.ready_for == b; });
    }
    std::memcpy(out_x, slot.xs.data(),
                size_t(batch) * out_sample_elems() * sizeof(float));
    std::memcpy(out_y, slot.ys.data(), size_t(batch) * sizeof(int32_t));
    {
      std::lock_guard<std::mutex> lk(mu);
      slot.ready_for = -1;
      next_consume = b + 1;
    }
    cv_free.notify_all();
    return 1;
  }
};

}  // namespace

extern "C" {

void* kl_create(const void* x, const int32_t* y, int64_t n, int h, int w, int c,
                int batch, int num_shards, int shard_index, int shuffle,
                int mode, int pad, int threads, int depth, int in_dtype,
                int out_h, int out_w, int resize_size) {
  if (!x || !y || n <= 0 || batch <= 0 || num_shards <= 0 || depth <= 0) return nullptr;
  if (in_dtype != 0 && in_dtype != 1) return nullptr;
  auto* L = new Loader();
  L->x = x; L->y = y; L->n = n; L->h = h; L->w = w; L->c = c;
  L->batch = batch; L->num_shards = num_shards; L->shard_index = shard_index;
  L->shuffle = shuffle != 0; L->mode = mode; L->pad = pad;
  L->threads = threads; L->depth = depth; L->in_dtype = in_dtype;
  L->out_h = out_h > 0 ? out_h : h;
  L->out_w = out_w > 0 ? out_w : w;
  L->resize_size = resize_size > 0 ? resize_size : 256;
  if (L->mode <= 1 && (L->out_h != h || L->out_w != w)) { delete L; return nullptr; }
  // mode 3: the shorter-side resize must cover the center crop (smaller
  // values would replicate borders; torchvision CenterCrop zero-pads)
  if (L->mode == 3 && L->resize_size < std::max(L->out_h, L->out_w)) {
    delete L;
    return nullptr;
  }
  L->slots.resize(depth);
  for (auto& s : L->slots) {
    s.xs.resize(size_t(batch) * L->out_sample_elems());
    s.ys.resize(batch);
  }
  return L;
}

void kl_set_norm(void* p, const float* mean, const float* stdev) {
  auto* L = static_cast<Loader*>(p);
  L->normalize = true;
  for (int i = 0; i < 3 && i < L->c; i++) {
    L->mean[i] = mean[i];
    L->stdev[i] = stdev[i];
  }
}

void kl_start_epoch(void* p, uint64_t seed) { static_cast<Loader*>(p)->start_epoch(seed); }

int64_t kl_num_batches(void* p) { return static_cast<Loader*>(p)->n_batches; }

int kl_next(void* p, float* out_x, int32_t* out_y) {
  return static_cast<Loader*>(p)->next(out_x, out_y);
}

void kl_destroy(void* p) {
  auto* L = static_cast<Loader*>(p);
  L->stop_pool();
  delete L;
}

// One-shot threaded batch transform (no epoch machinery): apply mode 2 (rrc,
// per-sample rng from seed^index) or mode 3 (centercrop) to n samples. For
// eval paths that bring their own batching/masking (training/data.py::
// eval_batches) but want the transform off the Python thread.
int kl_transform(const void* x, int64_t n, int h, int w, int c, int in_dtype,
                 float* out, int out_h, int out_w, int mode, int resize_size,
                 const float* mean, const float* stdev, uint64_t seed,
                 int threads) {
  if (!x || !out || n <= 0 || (mode != 2 && mode != 3)) return 0;
  if (in_dtype != 0 && in_dtype != 1) return 0;
  if (mode == 3 && (resize_size > 0 ? resize_size : 256) < std::max(out_h, out_w))
    return 0;
  Loader L;
  L.x = x;
  L.n = n;
  L.h = h; L.w = w; L.c = c;
  L.out_h = out_h; L.out_w = out_w;
  L.mode = mode;
  L.resize_size = resize_size > 0 ? resize_size : 256;
  L.in_dtype = in_dtype;
  if (mean && stdev) {
    L.normalize = true;
    for (int i = 0; i < 3 && i < c; i++) {
      L.mean[i] = mean[i];
      L.stdev[i] = stdev[i];
    }
  }
  const int64_t out_elems = L.out_sample_elems();
  const int nt = std::max(1, int(std::min<int64_t>(threads, n)));
  std::vector<std::thread> pool;
  std::atomic<int64_t> next{0};
  for (int t = 0; t < nt; t++) {
    pool.emplace_back([&] {
      for (;;) {
        const int64_t i = next.fetch_add(1);
        if (i >= n) return;
        const void* sx = L.sample_ptr(i);
        float* dx = out + i * out_elems;
        if (mode == 3) {
          L.fill_sample_centercrop(sx, dx);
        } else {
          uint64_t s = seed ^ (0xd1b54a32d192ed03ULL +
                               uint64_t(i) * 0x9e3779b97f4a7c15ULL);
          L.fill_sample_rrc(sx, dx, s);
        }
      }
    });
  }
  for (auto& t : pool) t.join();
  return 1;
}

}  // extern "C"
