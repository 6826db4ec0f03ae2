// Copied into turkish_asr_torch from turkish_asr_tpu/native/src/asr_native.cpp
// (the JAX package's host decoders), unchanged below this header, so that
// the port builds its native library (native/loader.py) from its own tree.
//
// Native host-side hot ops for turkish_asr_tpu.
//
// The reference offloads these to torchaudio's C++ kernels (wav decode,
// resample) and to C++ packages (kenlm, flashlight); jiwer's edit distance
// is Python. Here the host-side hot path is native C++ exposed over a C ABI
// and bound via ctypes (no pybind11 dependency):
//
//   - WAV decode (PCM 8/16/24/32 + IEEE float) -> float32 [-1, 1]
//   - windowed-sinc polyphase resampling (same math as audio/wavio.py)
//   - Levenshtein distance (token sequences) for WER/CER at corpus scale
//
// Build: g++ -O3 -march=native -shared -fPIC asr_native.cpp -o libasr_native.so

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// WAV decode
// ---------------------------------------------------------------------------

// Parses the RIFF container. Returns 0 on success.
// Pass out=nullptr to query sizes (n_samples per channel, channels, rate).
int wav_decode(const uint8_t* data, int64_t n_bytes,
               float* out, int64_t* n_samples, int* n_channels,
               int* sample_rate) {
  if (n_bytes < 12 || memcmp(data, "RIFF", 4) != 0 ||
      memcmp(data + 8, "WAVE", 4) != 0)
    return -1;

  int64_t pos = 12;
  int fmt_code = -1, channels = 0, bits = 0, rate = 0;
  const uint8_t* pcm = nullptr;
  int64_t pcm_bytes = 0;

  while (pos + 8 <= n_bytes) {
    uint32_t chunk_size;
    memcpy(&chunk_size, data + pos + 4, 4);
    const uint8_t* body = data + pos + 8;
    if (pos + 8 + (int64_t)chunk_size > n_bytes) {
      chunk_size = (uint32_t)(n_bytes - pos - 8);  // tolerate truncation
    }
    if (memcmp(data + pos, "fmt ", 4) == 0 && chunk_size >= 16) {
      uint16_t code16, ch16, bits16;
      uint32_t rate32;
      memcpy(&code16, body, 2);
      memcpy(&ch16, body + 2, 2);
      memcpy(&rate32, body + 4, 4);
      memcpy(&bits16, body + 14, 2);
      fmt_code = code16;
      channels = ch16;
      rate = (int)rate32;
      bits = bits16;
      if (fmt_code == 0xFFFE && chunk_size >= 40) {
        memcpy(&code16, body + 24, 2);
        fmt_code = code16;
      }
    } else if (memcmp(data + pos, "data", 4) == 0) {
      pcm = body;
      pcm_bytes = chunk_size;
    }
    pos += 8 + chunk_size + (chunk_size & 1);
  }
  if (fmt_code < 0 || pcm == nullptr || channels <= 0) return -2;

  int64_t frames;
  if (fmt_code == 1) {  // PCM
    int bytes_per = bits / 8;
    if (bits != 8 && bits != 16 && bits != 24 && bits != 32) return -3;
    frames = pcm_bytes / (bytes_per * channels);
  } else if (fmt_code == 3) {  // IEEE float
    int bytes_per = bits / 8;
    if (bits != 32 && bits != 64) return -3;
    frames = pcm_bytes / (bytes_per * channels);
  } else {
    return -4;
  }

  *n_samples = frames;
  *n_channels = channels;
  *sample_rate = rate;
  if (out == nullptr) return 0;  // size query

  // Deinterleave to (channels, frames), scaled to [-1, 1].
  for (int64_t f = 0; f < frames; ++f) {
    for (int c = 0; c < channels; ++c) {
      int64_t i = f * channels + c;
      float v = 0.f;
      if (fmt_code == 1) {
        if (bits == 8) {
          v = ((float)pcm[i] - 128.0f) / 128.0f;
        } else if (bits == 16) {
          int16_t s;
          memcpy(&s, pcm + 2 * i, 2);
          v = (float)s / 32768.0f;
        } else if (bits == 24) {
          int32_t s = pcm[3 * i] | (pcm[3 * i + 1] << 8) |
                      (pcm[3 * i + 2] << 16);
          if (s >= (1 << 23)) s -= (1 << 24);
          v = (float)s / 8388608.0f;
        } else {
          int32_t s;
          memcpy(&s, pcm + 4 * i, 4);
          v = (float)s / 2147483648.0f;
        }
      } else {
        if (bits == 32) {
          float s;
          memcpy(&s, pcm + 4 * i, 4);
          v = s;
        } else {
          double s;
          memcpy(&s, pcm + 8 * i, 8);
          v = (float)s;
        }
      }
      out[(int64_t)c * frames + f] = v;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Windowed-sinc polyphase resampling (matches audio/wavio.py numerics)
// ---------------------------------------------------------------------------

static int64_t gcd64(int64_t a, int64_t b) {
  while (b) { int64_t t = a % b; a = b; b = t; }
  return a;
}

// out must hold ceil(new_freq * n_in / orig_freq) floats (after gcd
// reduction the value is identical). Returns the produced length.
int64_t resample_f32(const float* in, int64_t n_in, float* out,
                     int orig_freq, int new_freq,
                     int lowpass_filter_width, double rolloff) {
  if (orig_freq == new_freq) {
    memcpy(out, in, sizeof(float) * n_in);
    return n_in;
  }
  int64_t g = gcd64(orig_freq, new_freq);
  int64_t o = orig_freq / g, n = new_freq / g;

  double base_freq = (double)std::min(o, n) * rolloff;
  int64_t width = (int64_t)std::ceil(lowpass_filter_width * o / base_freq);
  int64_t K = 2 * width + o;
  double scale = base_freq / (double)o;

  // Kernel bank (n phases x K taps), fp64 accumulation like numpy.
  std::vector<double> kernels((size_t)(n * K));
  for (int64_t ph = 0; ph < n; ++ph) {
    for (int64_t j = 0; j < K; ++j) {
      double idx = (double)(j - width) / (double)o;
      double t = (double)(-ph) / (double)n + idx;
      t *= base_freq;
      t = std::max(-(double)lowpass_filter_width,
                   std::min((double)lowpass_filter_width, t));
      double window = std::cos(t * M_PI / lowpass_filter_width / 2.0);
      window *= window;
      double tp = t * M_PI;
      double sinc = (tp == 0.0) ? 1.0 : std::sin(tp) / tp;
      kernels[(size_t)(ph * K + j)] = sinc * window * scale;
    }
  }

  int64_t target_length =
      (int64_t)std::ceil((double)n * (double)n_in / (double)o);
  // Padded input: width zeros left, width + o zeros right.
  int64_t padded_len = n_in + 2 * width + o;
  std::vector<float> padded((size_t)padded_len, 0.f);
  memcpy(padded.data() + width, in, sizeof(float) * n_in);

  int64_t num_hops = (padded_len - K) / o + 1;
  int64_t produced = 0;
  for (int64_t h = 0; h < num_hops && produced < target_length; ++h) {
    const float* seg = padded.data() + h * o;
    for (int64_t ph = 0; ph < n && produced < target_length; ++ph) {
      const double* kern = kernels.data() + ph * K;
      double acc = 0.0;
      for (int64_t j = 0; j < K; ++j) acc += (double)seg[j] * kern[j];
      out[produced++] = (float)acc;
    }
  }
  return produced;
}

// ---------------------------------------------------------------------------
// FLAC decode (self-contained; mirrors audio/flacio.py, the Python oracle)
//
// Supports STREAMINFO, all frame-header block-size/sample-rate/sample-size
// codes, UTF-8 coded frame numbers, subframes CONSTANT / VERBATIM /
// FIXED(0-4) / LPC(1-32), partitioned Rice residuals (4/5-bit params,
// escapes), wasted bits, and left/right/mid-side stereo decorrelation.
// CRCs are not verified (structural sync bits are).
// ---------------------------------------------------------------------------

namespace flac {

struct BitReader {
  const uint8_t* data;
  int64_t n;
  int64_t pos = 0;
  int bit = 0;
  bool fail = false;

  BitReader(const uint8_t* d, int64_t len, int64_t start = 0)
      : data(d), n(len), pos(start) {}

  uint64_t read(int nbits) {
    uint64_t out = 0;
    while (nbits > 0) {
      if (pos >= n) { fail = true; return 0; }
      int avail = 8 - bit;
      int take = nbits < avail ? nbits : avail;
      uint8_t byte = data[pos];
      out = (out << take) | ((byte >> (avail - take)) & ((1u << take) - 1));
      bit += take;
      nbits -= take;
      if (bit == 8) { bit = 0; ++pos; }
    }
    return out;
  }

  int64_t read_signed(int nbits) {
    uint64_t v = read(nbits);
    if (nbits < 64 && v >= (1ull << (nbits - 1)))
      return (int64_t)v - (int64_t)(1ull << nbits);
    return (int64_t)v;
  }

  int64_t read_unary() {
    int64_t count = 0;
    while (true) {
      if (pos >= n) { fail = true; return 0; }
      uint8_t rem = (uint8_t)(data[pos] << bit);
      if (rem == 0) {
        count += 8 - bit;
        ++pos;
        bit = 0;
        continue;
      }
      int lead = __builtin_clz((unsigned)rem) - 24;  // zeros in 8-bit view
      count += lead;
      bit += lead + 1;
      if (bit >= 8) { bit -= 8; ++pos; }
      return count;
    }
  }

  void align() {
    if (bit) { bit = 0; ++pos; }
  }
};

static int64_t read_utf8_number(BitReader& br) {
  uint64_t b0 = br.read(8);
  if (b0 < 0x80) return (int64_t)b0;
  int n_follow = 0;
  uint64_t mask = 0x40;
  while (b0 & mask) { ++n_follow; mask >>= 1; }
  if (n_follow == 0 || n_follow > 6) { br.fail = true; return -1; }
  uint64_t val = b0 & (mask - 1);
  for (int i = 0; i < n_follow; ++i) {
    uint64_t b = br.read(8);
    if ((b & 0xC0) != 0x80) { br.fail = true; return -1; }
    val = (val << 6) | (b & 0x3F);
  }
  return (int64_t)val;
}

static const int kBlockSizeTable[16] = {
    -1, 192, 576, 1152, 2304, 4608, 0, 0,
    256, 512, 1024, 2048, 4096, 8192, 16384, 32768};
static const int kSampleSizeTable[8] = {0, 8, 12, -1, 16, 20, 24, 32};
static const int kFixedCoeffs[5][4] = {
    {}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};

// Residual into resid[0..block_size-order).
static bool decode_residual(BitReader& br, int block_size, int order,
                            std::vector<int64_t>& resid) {
  int method = (int)br.read(2);
  if (method > 1) return false;
  int param_bits = method == 0 ? 4 : 5;
  unsigned escape = (1u << param_bits) - 1;
  int part_order = (int)br.read(4);
  int n_parts = 1 << part_order;
  if (block_size % n_parts) return false;
  resid.clear();
  resid.reserve(block_size - order);
  for (int p = 0; p < n_parts; ++p) {
    int count = block_size / n_parts - (p == 0 ? order : 0);
    if (count < 0) return false;
    unsigned param = (unsigned)br.read(param_bits);
    if (param == escape) {
      int raw_bits = (int)br.read(5);
      for (int i = 0; i < count; ++i)
        resid.push_back(raw_bits ? br.read_signed(raw_bits) : 0);
    } else {
      for (int i = 0; i < count; ++i) {
        uint64_t q = (uint64_t)br.read_unary();
        uint64_t v = (q << param) | (param ? br.read(param) : 0);
        resid.push_back((int64_t)(v >> 1) ^ -(int64_t)(v & 1));
      }
    }
    if (br.fail) return false;
  }
  return true;
}

static bool decode_subframe(BitReader& br, int block_size, int bps,
                            std::vector<int64_t>& samples) {
  if (br.read(1)) return false;  // subframe sync bit
  int stype = (int)br.read(6);
  int wasted = 0;
  if (br.read(1)) {
    wasted = (int)br.read_unary() + 1;
    bps -= wasted;
  }
  if (bps <= 0 || br.fail) return false;

  samples.clear();
  samples.reserve(block_size);
  std::vector<int64_t> resid;
  if (stype == 0) {  // CONSTANT
    int64_t v = br.read_signed(bps);
    samples.assign(block_size, v);
  } else if (stype == 1) {  // VERBATIM
    for (int i = 0; i < block_size; ++i)
      samples.push_back(br.read_signed(bps));
  } else if (stype >= 8 && stype <= 12) {  // FIXED
    int order = stype - 8;
    for (int i = 0; i < order; ++i) samples.push_back(br.read_signed(bps));
    if (!decode_residual(br, block_size, order, resid)) return false;
    const int* coef = kFixedCoeffs[order];
    for (size_t i = 0; i < resid.size(); ++i) {
      int64_t pred = 0;
      size_t base = order + i;
      for (int j = 0; j < order; ++j) pred += coef[j] * samples[base - 1 - j];
      samples.push_back(pred + resid[i]);
    }
  } else if (stype >= 32) {  // LPC
    int order = stype - 31;
    for (int i = 0; i < order; ++i) samples.push_back(br.read_signed(bps));
    int precision = (int)br.read(4) + 1;
    if (precision == 16) return false;
    int shift = (int)br.read_signed(5);
    if (shift < 0) return false;
    std::vector<int64_t> coefs(order);
    for (int i = 0; i < order; ++i) coefs[i] = br.read_signed(precision);
    if (!decode_residual(br, block_size, order, resid)) return false;
    for (size_t i = 0; i < resid.size(); ++i) {
      int64_t acc = 0;
      size_t base = order + i;
      for (int j = 0; j < order; ++j) acc += coefs[j] * samples[base - 1 - j];
      samples.push_back((acc >> shift) + resid[i]);
    }
  } else {
    return false;  // reserved type
  }
  if (br.fail) return false;
  if (wasted)
    for (auto& s : samples) s <<= wasted;
  return true;
}

}  // namespace flac

// Decode a FLAC stream -> float32 (channels, samples) in [-1, 1].
// Two-phase like wav_decode: out=nullptr queries sizes (from STREAMINFO
// total_samples). Returns 0 ok; -1 not FLAC; -5 needs-Python-fallback
// (unknown total); any other negative = malformed stream.
int flac_decode(const uint8_t* data, int64_t n_bytes, float* out,
                int64_t* n_samples, int* n_channels, int* sample_rate) {
  if (n_bytes < 42 || memcmp(data, "fLaC", 4) != 0) return -1;
  int64_t pos = 4;
  int rate = 0, channels = 0, bps = 0;
  int64_t total = -1;
  while (pos + 4 <= n_bytes) {
    uint8_t head = data[pos];
    bool last = head & 0x80;
    int btype = head & 0x7F;
    int64_t length = ((int64_t)data[pos + 1] << 16) |
                     ((int64_t)data[pos + 2] << 8) | data[pos + 3];
    if (pos + 4 + length > n_bytes) return -2;
    if (btype == 0 && length >= 34) {
      flac::BitReader br(data + pos + 4, length);
      br.read(16); br.read(16); br.read(24); br.read(24);
      rate = (int)br.read(20);
      channels = (int)br.read(3) + 1;
      bps = (int)br.read(5) + 1;
      total = (int64_t)br.read(36);
    }
    pos += 4 + length;
    if (last) break;
  }
  if (rate <= 0 || channels <= 0 || bps <= 0 || total < 0) return -2;
  if (total == 0) return -5;  // unknown length: Python fallback counts

  *n_samples = total;
  *n_channels = channels;
  *sample_rate = rate;
  if (out == nullptr) return 0;  // size query

  flac::BitReader br(data, n_bytes, pos);
  std::vector<std::vector<int64_t>> sub((size_t)channels);
  int64_t done = 0;
  float scale = 1.0f / (float)(1ull << (bps - 1));
  while (done < total) {
    // frame header
    if (br.read(14) != 0x3FFE) return -3;
    br.read(1);
    br.read(1);
    int bs_code = (int)br.read(4);
    int sr_code = (int)br.read(4);
    int ch_code = (int)br.read(4);
    int ss_code = (int)br.read(3);
    br.read(1);
    if (flac::read_utf8_number(br) < 0) return -3;
    int block_size;
    if (bs_code == 0) return -3;
    else if (bs_code == 6) block_size = (int)br.read(8) + 1;
    else if (bs_code == 7) block_size = (int)br.read(16) + 1;
    else block_size = flac::kBlockSizeTable[bs_code];
    if (sr_code == 12) br.read(8);
    else if (sr_code == 13 || sr_code == 14) br.read(16);
    else if (sr_code == 15) return -3;
    int frame_bps = flac::kSampleSizeTable[ss_code];
    if (frame_bps == 0) frame_bps = bps;
    if (frame_bps < 0) return -3;
    br.read(8);  // CRC-8
    if (br.fail || block_size <= 0) return -3;

    int frame_ch = ch_code < 8 ? ch_code + 1 : 2;
    if (frame_ch != channels) return -3;
    if (ch_code < 8) {
      for (int c = 0; c < channels; ++c)
        if (!flac::decode_subframe(br, block_size, frame_bps, sub[c]))
          return -4;
    } else if (ch_code == 8) {  // left/side
      std::vector<int64_t> side;
      if (!flac::decode_subframe(br, block_size, frame_bps, sub[0]) ||
          !flac::decode_subframe(br, block_size, frame_bps + 1, side))
        return -4;
      sub[1].resize(block_size);
      for (int i = 0; i < block_size; ++i) sub[1][i] = sub[0][i] - side[i];
    } else if (ch_code == 9) {  // right/side
      std::vector<int64_t> side;
      if (!flac::decode_subframe(br, block_size, frame_bps + 1, side) ||
          !flac::decode_subframe(br, block_size, frame_bps, sub[1]))
        return -4;
      sub[0].resize(block_size);
      for (int i = 0; i < block_size; ++i) sub[0][i] = sub[1][i] + side[i];
    } else if (ch_code == 10) {  // mid/side
      std::vector<int64_t> mid, side;
      if (!flac::decode_subframe(br, block_size, frame_bps, mid) ||
          !flac::decode_subframe(br, block_size, frame_bps + 1, side))
        return -4;
      sub[0].resize(block_size);
      sub[1].resize(block_size);
      for (int i = 0; i < block_size; ++i) {
        int64_t m = (mid[i] << 1) | (side[i] & 1);
        sub[0][i] = (m + side[i]) >> 1;
        sub[1][i] = (m - side[i]) >> 1;
      }
    } else {
      return -3;
    }
    br.align();
    br.read(16);  // CRC-16
    if (br.fail) return -4;

    int64_t take = block_size;
    if (done + take > total) take = total - done;  // clamp final frame
    for (int c = 0; c < channels; ++c) {
      float* dst = out + (int64_t)c * total + done;
      for (int64_t i = 0; i < take; ++i)
        dst[i] = (float)sub[c][i] * scale;
    }
    done += take;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Levenshtein distance over int32 token sequences
// ---------------------------------------------------------------------------

int64_t levenshtein_i32(const int32_t* a, int64_t na,
                        const int32_t* b, int64_t nb) {
  if (na == 0) return nb;
  if (nb == 0) return na;
  std::vector<int64_t> prev(nb + 1), curr(nb + 1);
  for (int64_t j = 0; j <= nb; ++j) prev[j] = j;
  for (int64_t i = 1; i <= na; ++i) {
    curr[0] = i;
    int32_t ai = a[i - 1];
    for (int64_t j = 1; j <= nb; ++j) {
      int64_t cost = (ai == b[j - 1]) ? 0 : 1;
      curr[j] = std::min({prev[j] + 1, curr[j - 1] + 1, prev[j - 1] + cost});
    }
    std::swap(prev, curr);
  }
  return prev[nb];
}

}  // extern "C"
