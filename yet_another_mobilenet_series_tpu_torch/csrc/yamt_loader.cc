// Copy of native/yamt_loader.cc: the port builds its own loader library from this file (ops/host_build.py),
// so it never builds into, or loads from, the JAX package's native/ directory.
// Native input pipeline: multithreaded JPEG decode + augment.
//
// This is the framework's DALI replacement (SURVEY.md §2 #6 and the native
// dependency table): the reference fed GPUs with NVIDIA DALI's C++/CUDA
// decode+augment pipeline; TPU hosts decode on CPU, so the same role is a
// C++ thread pool that JPEG-decodes (libjpeg, with fractional DCT scaling
// for cheap downscale), applies Inception-style random-resized-crop or the
// resize-shorter/center-crop eval transform, bilinear-resizes, flips, and
// normalizes straight into pinned float32 NHWC batch buffers handed to
// Python over a zero-copy ctypes API (data/native_loader.py).
//
// Threading model: workers claim individual (batch, sample) tasks from the
// oldest open batch first (work stealing WITHIN a batch — so time-to-first-
// batch scales with cores, not with batch size), decoding into per-sample
// slots of a ring of batch buffers; a batch becomes ready when all its
// samples are done. The consumer (Python) blocks in loader_next() on the
// ready queue. Deterministic per-epoch shuffling derives from (seed, epoch);
// per-sample augment RNG from (seed, batch, index) so results are
// reproducible regardless of thread interleaving or thread count.
//
// Eval exactness: with epoch_batches > 0 each pass is padded up to that many
// batches and positions past the sample list carry label -1 (masked by the
// eval step) — every example counts exactly once. Train decode failures are
// retried on deterministically-resampled indices; eval failures yield
// label -1 so a corrupt file can never count as a confident black image.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <setjmp.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Config {
  int image_size;
  int eval_resize;
  int batch;
  int num_threads;
  int train;  // 1 = random-resized-crop + flip; 0 = resize + center crop
  uint64_t seed;
  float mean[3];
  float std[3];
  float rrc_area_min, rrc_area_max, rrc_ratio_min, rrc_ratio_max;
  // torchvision-ColorJitter-style strength (brightness/contrast/saturation
  // factors ~ U[1-s, 1+s]); 0 = off. Train only.
  float color_jitter;
  // >0: every pass serves exactly this many batches, padding positions past
  // the sample list with label -1 (exact eval counting). 0: train semantics
  // (drop remainder).
  int64_t epoch_batches;
  // Resume position: the stream starts at this GLOBAL batch index instead
  // of 0. Every batch is a pure function of its global index (epoch order
  // from (seed, epoch); per-sample augment RNG from (seed, global_batch,
  // i)), so starting the producer/consumer cursors here reproduces batch
  // start_batch, start_batch+1, ... of an uninterrupted run bit-for-bit —
  // a resumed training run continues the data order rather than replaying
  // the epoch-0 shuffle (SURVEY.md §5 checkpoint bullet; VERDICT r3 #2).
  int64_t start_batch;
  // 1: emit raw uint8 pixels (normalize moves in-step on device —
  // data.transfer_uint8, 4x less host->device volume; the float augment
  // pipeline is unchanged, workers quantize round+clip into the u8 ring).
  int transfer_uint8;
};

struct Sample {
  std::string path;
  int32_t label;
};

// --- decode ----------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decodes a JPEG file into an RGB u8 buffer. target_min > 0 picks the
// largest DCT scale_denom in {1,2,4,8} that keeps min(w,h) >= target_min —
// libjpeg then decodes at reduced resolution nearly for free (the eval
// fast path; train decodes full-res because RRC crops arbitrary regions).
bool decode_jpeg(const std::string& path, std::vector<uint8_t>* out, int* w, int* h,
                 int target_min) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  int denom = 1;
  if (target_min > 0) {
    const int src_min = std::min<int>(cinfo.image_width, cinfo.image_height);
    while (denom < 8 && src_min / (denom * 2) >= target_min) denom *= 2;
  }
  cinfo.scale_num = 1;
  cinfo.scale_denom = denom;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  out->resize(size_t(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() + size_t(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// --- resize / crop ---------------------------------------------------------

// Bilinear crop-and-resize from src (sw x sh RGB u8, crop rect) to a
// dst_size x dst_size float32 HWC tile in [0, 255], optionally mirrored.
// Jitter and normalization run as separate passes over the tile.
void crop_resize(const uint8_t* src, int sw, int sh, int cx, int cy, int cw, int ch,
                 float* dst, int dst_size, bool flip) {
  const float sx = float(cw) / dst_size;
  const float sy = float(ch) / dst_size;
  for (int y = 0; y < dst_size; ++y) {
    const float fy = cy + (y + 0.5f) * sy - 0.5f;
    const int y0 = std::clamp(int(std::floor(fy)), 0, sh - 1);
    const int y1 = std::min(y0 + 1, sh - 1);
    const float wy = fy - std::floor(fy);
    for (int x = 0; x < dst_size; ++x) {
      const float fx = cx + (x + 0.5f) * sx - 0.5f;
      const int x0 = std::clamp(int(std::floor(fx)), 0, sw - 1);
      const int x1 = std::min(x0 + 1, sw - 1);
      const float wx = fx - std::floor(fx);
      const int ox = flip ? (dst_size - 1 - x) : x;
      float* d = dst + (size_t(y) * dst_size + ox) * 3;
      for (int c = 0; c < 3; ++c) {
        const float v00 = src[(size_t(y0) * sw + x0) * 3 + c];
        const float v01 = src[(size_t(y0) * sw + x1) * 3 + c];
        const float v10 = src[(size_t(y1) * sw + x0) * 3 + c];
        const float v11 = src[(size_t(y1) * sw + x1) * 3 + c];
        d[c] = (1 - wy) * ((1 - wx) * v00 + wx * v01) +
               wy * ((1 - wx) * v10 + wx * v11);
      }
    }
  }
}

inline float luminance(const float* px) {
  return 0.2989f * px[0] + 0.587f * px[1] + 0.114f * px[2];
}

// torchvision-ColorJitter semantics on a [0,255] tile, fixed order b->c->s:
// brightness multiplies, contrast blends with the mean of the grayscale
// image, saturation blends with the per-pixel grayscale; each op clamps to
// the valid range (matching torchvision's saturating arithmetic). The
// tf.data path implements the identical definition (data/pipeline.py
// _color_jitter) so the two loaders' augmentations agree.
void color_jitter(float* dst, int dst_size, float fb, float fc, float fs) {
  const int n = dst_size * dst_size;
  auto clamp255 = [](float v) { return std::clamp(v, 0.0f, 255.0f); };
  for (int i = 0; i < n * 3; ++i) dst[i] = clamp255(dst[i] * fb);
  double gsum = 0.0;
  for (int i = 0; i < n; ++i) gsum += luminance(dst + size_t(i) * 3);
  const float gm = float(gsum / n);
  for (int i = 0; i < n * 3; ++i) dst[i] = clamp255(gm + (dst[i] - gm) * fc);
  for (int i = 0; i < n; ++i) {
    float* px = dst + size_t(i) * 3;
    const float g = luminance(px);
    for (int c = 0; c < 3; ++c) px[c] = clamp255(g + (px[c] - g) * fs);
  }
}

void normalize(float* dst, int dst_size, const Config& cfg) {
  const int n = dst_size * dst_size;
  for (int i = 0; i < n; ++i) {
    float* px = dst + size_t(i) * 3;
    for (int c = 0; c < 3; ++c) px[c] = (px[c] / 255.0f - cfg.mean[c]) / cfg.std[c];
  }
}

// Inception-style random-resized-crop parameters (the reference's train
// augmentation; parameters surfaced in DataConfig).
void sample_rrc(std::mt19937_64& rng, int w, int h, const Config& cfg, int* cx, int* cy,
                int* cw, int* ch) {
  std::uniform_real_distribution<float> u01(0.0f, 1.0f);
  const float area = float(w) * h;
  for (int attempt = 0; attempt < 10; ++attempt) {
    const float target_area =
        area * (cfg.rrc_area_min + u01(rng) * (cfg.rrc_area_max - cfg.rrc_area_min));
    const float log_min = std::log(cfg.rrc_ratio_min);
    const float log_max = std::log(cfg.rrc_ratio_max);
    const float ratio = std::exp(log_min + u01(rng) * (log_max - log_min));
    const int tw = int(std::lround(std::sqrt(target_area * ratio)));
    const int th = int(std::lround(std::sqrt(target_area / ratio)));
    if (tw > 0 && th > 0 && tw <= w && th <= h) {
      *cx = int(u01(rng) * (w - tw + 1));
      *cy = int(u01(rng) * (h - th + 1));
      *cw = tw;
      *ch = th;
      return;
    }
  }
  // fallback: center crop of the largest valid square
  const int s = std::min(w, h);
  *cx = (w - s) / 2;
  *cy = (h - s) / 2;
  *cw = s;
  *ch = s;
}

// --- loader ----------------------------------------------------------------

struct BatchBuf {
  std::vector<float> images;    // f32 mode (host-normalized)
  std::vector<uint8_t> images8; // transfer_uint8 mode (raw pixels)
  std::vector<int32_t> labels;
  int64_t batch_index = -1;  // global batch id this buffer holds
};

// A batch whose samples are still being claimed/decoded. Workers claim the
// oldest open batch's next sample first, so all cores converge on the batch
// the consumer needs next.
struct OpenBatch {
  int slot;
  int64_t gb;
  int next_i;  // claim cursor
  int done;    // completed samples
};

struct Loader {
  Config cfg;
  std::vector<Sample> samples;
  // Immutable per-epoch shuffles, built on demand under mu and then shared
  // read-only. Workers prefetching across an epoch boundary hold different
  // epochs' orders concurrently — a single mutable vector would be a data
  // race. Old epochs are evicted once no new batch can reference them.
  std::map<int64_t, std::shared_ptr<const std::vector<uint32_t>>> orders;

  std::vector<BatchBuf> ring;
  std::map<int64_t, int> ready;     // batch index -> ring slot, consumer side
  std::queue<int> free_slots;       // ring slots available to fill
  std::vector<OpenBatch> open;      // batches mid-decode (oldest first)
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::atomic<int64_t> next_batch{0};   // producer cursor (global batch id)
  int64_t consumed = 0;                 // consumer cursor
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::atomic<int64_t> decode_failures{0};

  int64_t batches_per_epoch() const {
    if (cfg.epoch_batches > 0) return cfg.epoch_batches;  // padded pass (eval)
    return int64_t(samples.size()) / cfg.batch;  // drop_remainder, like train
  }

  std::shared_ptr<const std::vector<uint32_t>> epoch_order(int64_t e) {
    std::lock_guard<std::mutex> lk(mu);
    auto it = orders.find(e);
    if (it != orders.end()) return it->second;
    auto ord = std::make_shared<std::vector<uint32_t>>(samples.size());
    for (uint32_t i = 0; i < ord->size(); ++i) (*ord)[i] = i;
    if (cfg.train) {
      std::mt19937_64 rng(cfg.seed * 0x9E3779B97F4A7C15ULL + e);
      std::shuffle(ord->begin(), ord->end(), rng);
    }
    orders.emplace(e, ord);
    // Bound the cache. NOTE: return the local shared_ptr, NOT orders[e] —
    // when a straggler inserts an epoch older than everything cached, the
    // eviction below removes exactly that entry, and orders[e] would then
    // materialize a null pointer. An evicted epoch is simply recomputed on
    // next request (the permutation is a pure function of seed+epoch).
    while (orders.size() > 3) orders.erase(orders.begin());
    return ord;
  }

  void zero_sample(BatchBuf& buf, int i, int32_t label) {
    const size_t n = size_t(cfg.image_size) * cfg.image_size * 3;
    if (cfg.transfer_uint8) {
      // f32 mode emits NORMALIZED zeros (the mean pixel); the u8
      // equivalent is mean*255 per channel — raw zeros would device-
      // normalize to -mean/std (a black image), diverging the two modes
      // far beyond the quantization bound on decode-failed samples
      uint8_t fill[3];
      for (int c = 0; c < 3; ++c)
        fill[c] = uint8_t(std::clamp(std::lround(cfg.mean[c] * 255.0f), 0L, 255L));
      uint8_t* dst = buf.images8.data() + size_t(i) * n;
      for (size_t p = 0; p < n; ++p) dst[p] = fill[p % 3];
    } else {
      std::memset(buf.images.data() + size_t(i) * n, 0, sizeof(float) * n);
    }
    buf.labels[i] = label;
  }

  static constexpr int kDecodeAttempts = 8;

  void fill_sample(BatchBuf& buf, int64_t global_batch, int i) {
    const int64_t bpe = batches_per_epoch();
    const int64_t e = global_batch / bpe;
    const auto order_ptr = epoch_order(e);
    const std::vector<uint32_t>& order = *order_ptr;
    const int64_t pos = (global_batch % bpe) * cfg.batch + i;
    if (pos >= int64_t(order.size())) {
      // padded tail of an exact eval pass: label -1 is masked by the eval step
      zero_sample(buf, i, -1);
      return;
    }
    std::mt19937_64 rng(cfg.seed ^ (uint64_t(global_batch) << 20) ^ uint64_t(i) * 0x2545F4914F6CDD1DULL);

    // Train: a corrupt file retries on deterministically-resampled indices
    // (still reproducible across thread counts); eval keeps the file slot but
    // yields label -1 so it can never count as a confidently-labeled black
    // image. If every attempt fails the dataset is broken wholesale — emit
    // zeros with the last label and let the decode_failures counter (logged
    // by the train loop) surface it.
    const int attempts = cfg.train ? kDecodeAttempts : 1;
    std::vector<uint8_t> rgb;
    int w = 0, h = 0;
    const Sample* s = nullptr;
    bool ok = false;
    for (int a = 0; a < attempts && !ok; ++a) {
      s = &samples[order[(pos + int64_t(a) * 9973) % order.size()]];
      ok = decode_jpeg(s->path, &rgb, &w, &h, cfg.train ? 0 : cfg.eval_resize);
      if (!ok) decode_failures.fetch_add(1);
    }
    if (!ok || w <= 0 || h <= 0) {
      zero_sample(buf, i, cfg.train ? s->label : -1);
      return;
    }
    const size_t tile = size_t(cfg.image_size) * cfg.image_size * 3;
    // transfer_uint8: augment into a thread-local float tile, quantize into
    // the u8 ring at the end — the float pipeline (and its exact jitter
    // semantics) is shared verbatim between the two output modes
    thread_local std::vector<float> staging;
    float* dst;
    if (cfg.transfer_uint8) {
      staging.resize(tile);
      dst = staging.data();
    } else {
      dst = buf.images.data() + size_t(i) * tile;
    }
    if (cfg.train) {
      int cx, cy, cw, ch;
      sample_rrc(rng, w, h, cfg, &cx, &cy, &cw, &ch);
      const bool flip = std::uniform_int_distribution<int>(0, 1)(rng) == 1;
      crop_resize(rgb.data(), w, h, cx, cy, cw, ch, dst, cfg.image_size, flip);
      if (cfg.color_jitter > 0.0f) {
        std::uniform_real_distribution<float> uj(1.0f - cfg.color_jitter, 1.0f + cfg.color_jitter);
        const float fb = uj(rng), fc = uj(rng), fs = uj(rng);
        color_jitter(dst, cfg.image_size, fb, fc, fs);
      }
    } else {
      // resize shorter side to eval_resize, center-crop image_size — done in
      // one bilinear pass by cropping the source rect that maps onto the
      // final tile
      const float scale = float(cfg.eval_resize) / std::min(w, h);
      const float crop_src = cfg.image_size / scale;
      const float cx = (w - crop_src) / 2.0f;
      const float cy = (h - crop_src) / 2.0f;
      crop_resize(rgb.data(), w, h, int(std::lround(cx)), int(std::lround(cy)),
                  int(std::lround(crop_src)), int(std::lround(crop_src)), dst,
                  cfg.image_size, false);
    }
    if (cfg.transfer_uint8) {
      uint8_t* out = buf.images8.data() + size_t(i) * tile;
      for (size_t p = 0; p < tile; ++p)
        out[p] = uint8_t(std::clamp(std::lround(dst[p]), 0L, 255L));
    } else {
      normalize(dst, cfg.image_size, cfg);
    }
    buf.labels[i] = s->label;
  }

  // True when a worker has something to do: an unclaimed sample in an open
  // batch, or a free slot to open a new batch into. Call with mu held.
  bool has_task_locked() const {
    for (const auto& o : open)
      if (o.next_i < cfg.batch) return true;
    return !free_slots.empty();
  }

  void worker() {
    while (!stop.load()) {
      int slot;
      int64_t gb;
      int i;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_free.wait(lk, [&] { return stop.load() || has_task_locked(); });
        if (stop.load()) return;
        OpenBatch* ob = nullptr;
        for (auto& o : open)
          if (o.next_i < cfg.batch) { ob = &o; break; }  // oldest first
        if (ob == nullptr) {
          const int s = free_slots.front();
          free_slots.pop();
          const int64_t g = next_batch.fetch_add(1);
          ring[s].batch_index = g;
          open.push_back(OpenBatch{s, g, 0, 0});
          ob = &open.back();
          if (cfg.batch > 1) cv_free.notify_all();  // more samples up for grabs
        }
        slot = ob->slot;
        gb = ob->gb;
        i = ob->next_i++;
      }
      fill_sample(ring[slot], gb, i);
      {
        std::lock_guard<std::mutex> lk(mu);
        for (auto it = open.begin(); it != open.end(); ++it) {
          if (it->gb == gb) {
            if (++(it->done) == cfg.batch) {
              ready.emplace(gb, slot);
              open.erase(it);
              cv_ready.notify_all();
            }
            break;
          }
        }
      }
    }
  }

  // consumer: blocks until the ring holds batch `consumed`, returns its slot
  int wait_batch() {
    std::unique_lock<std::mutex> lk(mu);
    cv_ready.wait(lk, [&] { return stop.load() || ready.count(consumed) > 0; });
    if (stop.load()) return -1;
    const int slot = ready[consumed];
    ready.erase(consumed);
    consumed++;
    return slot;
  }
};

}  // namespace

extern "C" {

void* loader_create(int image_size, int eval_resize, int batch, int num_threads,
                    int train, uint64_t seed, const float* mean, const float* std_,
                    float area_min, float area_max, float ratio_min, float ratio_max,
                    float color_jitter, int64_t epoch_batches, int64_t start_batch,
                    int transfer_uint8) {
  auto* L = new Loader();
  L->cfg = Config{image_size, eval_resize, batch, num_threads, train, seed,
                  {mean[0], mean[1], mean[2]}, {std_[0], std_[1], std_[2]},
                  area_min, area_max, ratio_min, ratio_max,
                  color_jitter, epoch_batches, start_batch, transfer_uint8};
  return L;
}

void loader_add_file(void* handle, const char* path, int32_t label) {
  auto* L = static_cast<Loader*>(handle);
  L->samples.push_back({path, label});
}

int loader_start(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  // padded (exact-eval) passes may hold ANY sample count — including zero
  // (a host whose shard is empty serves all-dummy label=-1 batches so the
  // collective eval step count still matches its peers). Streaming
  // drop-remainder passes need at least one full batch.
  if (L->cfg.epoch_batches <= 0 && int(L->samples.size()) < L->cfg.batch) return -1;
  // resume: both cursors begin at the requested global batch — workers
  // produce batches start_batch, start_batch+1, ... and the consumer waits
  // for exactly those indices
  L->next_batch.store(L->cfg.start_batch);
  L->consumed = L->cfg.start_batch;
  const int depth = std::max(2 * L->cfg.num_threads, 4);
  L->ring.resize(depth);
  for (int i = 0; i < depth; ++i) {
    const size_t n = size_t(L->cfg.batch) * L->cfg.image_size * L->cfg.image_size * 3;
    if (L->cfg.transfer_uint8) L->ring[i].images8.resize(n);
    else L->ring[i].images.resize(n);
    L->ring[i].labels.resize(L->cfg.batch);
    L->free_slots.push(i);
  }
  for (int t = 0; t < L->cfg.num_threads; ++t) {
    L->workers.emplace_back([L] { L->worker(); });
  }
  return 0;
}

// Blocks until the next in-order batch is decoded, then copies it out.
// Returns 0 on success.
int loader_next(void* handle, float* images_out, int32_t* labels_out) {
  auto* L = static_cast<Loader*>(handle);
  if (L->cfg.transfer_uint8) return -2;  // wrong mode: u8 loader, f32 copy-out
  const int slot = L->wait_batch();
  if (slot < 0) return -1;
  BatchBuf& buf = L->ring[slot];
  std::memcpy(images_out, buf.images.data(), buf.images.size() * sizeof(float));
  std::memcpy(labels_out, buf.labels.data(), buf.labels.size() * sizeof(int32_t));
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->free_slots.push(slot);
  }
  L->cv_free.notify_all();
  return 0;
}

// transfer_uint8 copy-out: raw pixels, 4x smaller than the f32 batch.
int loader_next_u8(void* handle, uint8_t* images_out, int32_t* labels_out) {
  auto* L = static_cast<Loader*>(handle);
  if (!L->cfg.transfer_uint8) return -2;  // wrong mode: f32 loader, u8 copy-out
  const int slot = L->wait_batch();
  if (slot < 0) return -1;
  BatchBuf& buf = L->ring[slot];
  std::memcpy(images_out, buf.images8.data(), buf.images8.size());
  std::memcpy(labels_out, buf.labels.data(), buf.labels.size() * sizeof(int32_t));
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->free_slots.push(slot);
  }
  L->cv_free.notify_all();
  return 0;
}

int64_t loader_decode_failures(void* handle) {
  return static_cast<Loader*>(handle)->decode_failures.load();
}

int64_t loader_num_samples(void* handle) {
  return int64_t(static_cast<Loader*>(handle)->samples.size());
}

void loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  L->stop.store(true);
  L->cv_free.notify_all();
  L->cv_ready.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
