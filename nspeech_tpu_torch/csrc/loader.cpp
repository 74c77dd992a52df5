/*
 * Host audio loader of nspeech_tpu_torch: a copy of the JAX package's
 * native loader (nspeech_tpu/native/_loader.cpp) with its decoding and DSP
 * core unchanged: WAV decoding (PCM 8/16/24/32 and float32), FLAC decoding
 * (RFC 9639), mono mixdown, the Kaiser-windowed polyphase resampler and
 * framewise RMS.
 *
 * The CPython/numpy binding is replaced by a plain C interface (bottom of
 * the file), bound with ctypes by nspeech_tpu_torch/native/__init__.py, so
 * the build needs g++ alone: no Python or numpy headers. ctypes releases
 * the GIL around each call, so feeder threads overlap as they do with the
 * JAX binding.
 */

#include <algorithm>
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <vector>


namespace {

// ---------------------------------------------------------------------------
// WAV decoding
// ---------------------------------------------------------------------------

struct WavData {
  std::vector<float> samples;  // mono, [-1, 1]
  int sample_rate = 0;
  std::string error;
};

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

WavData decode_wav(const uint8_t* data, size_t size) {
  WavData out;
  if (size < 44 || std::memcmp(data, "RIFF", 4) != 0 ||
      std::memcmp(data + 8, "WAVE", 4) != 0) {
    out.error = "not a RIFF/WAVE file";
    return out;
  }
  size_t pos = 12;
  uint16_t format = 0, channels = 0, bits = 0;
  const uint8_t* payload = nullptr;
  size_t payload_size = 0;
  while (pos + 8 <= size) {
    const uint8_t* hdr = data + pos;
    uint32_t chunk_size = rd_u32(hdr + 4);
    const uint8_t* body = hdr + 8;
    if (pos + 8 + chunk_size > size) chunk_size = (uint32_t)(size - pos - 8);
    if (std::memcmp(hdr, "fmt ", 4) == 0 && chunk_size >= 16) {
      format = rd_u16(body);
      channels = rd_u16(body + 2);
      out.sample_rate = (int)rd_u32(body + 4);
      bits = rd_u16(body + 14);
      if (format == 0xFFFE && chunk_size >= 40) {
        format = rd_u16(body + 24);  // WAVE_FORMAT_EXTENSIBLE subformat tag
      }
    } else if (std::memcmp(hdr, "data", 4) == 0) {
      payload = body;
      payload_size = chunk_size;
    }
    pos += 8 + chunk_size + (chunk_size & 1);  // chunks are 2-byte aligned
  }
  if (!payload || channels == 0) {
    out.error = "missing fmt/data chunk";
    return out;
  }
  const size_t bytes_per_sample = bits / 8;
  if (bytes_per_sample == 0) {
    out.error = "bad bits-per-sample";
    return out;
  }
  const size_t n_frames = payload_size / (bytes_per_sample * channels);
  out.samples.resize(n_frames);
  const double inv_channels = 1.0 / channels;

  for (size_t i = 0; i < n_frames; ++i) {
    double acc = 0.0;
    for (unsigned c = 0; c < channels; ++c) {
      const uint8_t* p = payload + (i * channels + c) * bytes_per_sample;
      double v = 0.0;
      if (format == 3 && bits == 32) {  // IEEE float
        float f;
        std::memcpy(&f, p, 4);
        v = f;
      } else if (bits == 16) {
        int16_t s = (int16_t)rd_u16(p);
        v = s / 32768.0;
      } else if (bits == 32) {
        int32_t s = (int32_t)rd_u32(p);
        v = s / 2147483648.0;
      } else if (bits == 24) {
        int32_t s = ((int32_t)p[0] << 8) | ((int32_t)p[1] << 16) |
                    ((int32_t)p[2] << 24);
        v = (s >> 8) / 8388608.0;
      } else if (bits == 8) {
        v = ((int)p[0] - 128) / 128.0;
      }
      acc += v;
    }
    out.samples[i] = (float)(acc * inv_channels);
  }
  return out;
}

// ---------------------------------------------------------------------------
// FLAC decoding (RFC 9639). LibriSpeech-style corpora ship .flac; the
// reference decoded them through librosa/audioread (SURVEY.md §2.5) — this
// environment has no flac library at all, so the decoder is implemented
// from the format spec: STREAMINFO, frame headers (sync/CRC-8), subframe
// types CONSTANT/VERBATIM/FIXED(0-4)/LPC(1-32), rice/rice2 partitioned
// residuals with escapes, wasted bits, stereo decorrelation
// (left/right/mid-side), frame CRC-16. Validated against an independently
// written pure-Python encoder AND decoder (tests/make_flac.py,
// nspeech_tpu/dsp/flacio.py).
// ---------------------------------------------------------------------------

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;  // byte position
  int bit = 0;     // bits consumed of data[pos] (0..7), MSB first
  bool ok = true;

  BitReader(const uint8_t* d, size_t s) : data(d), size(s) {}

  uint64_t read_bits(int n) {  // n <= 57, MSB-first
    uint64_t v = 0;
    while (n > 0) {
      if (pos >= size) {
        ok = false;
        return 0;
      }
      const int avail = 8 - bit;
      const int take = n < avail ? n : avail;
      const uint32_t chunk =
          (data[pos] >> (avail - take)) & ((1u << take) - 1u);
      v = (v << take) | chunk;
      bit += take;
      n -= take;
      if (bit == 8) {
        bit = 0;
        ++pos;
      }
    }
    return v;
  }

  int64_t read_signed(int n) {  // two's complement
    if (n == 0) return 0;
    const uint64_t v = read_bits(n);
    if (v & (1ULL << (n - 1))) return (int64_t)v - ((int64_t)1 << n);
    return (int64_t)v;
  }

  uint32_t read_unary() {  // count of 0 bits before the terminating 1
    uint32_t q = 0;
    for (;;) {
      if (pos >= size) {
        ok = false;
        return 0;
      }
      const uint32_t b = (data[pos] >> (7 - bit)) & 1u;
      ++bit;
      if (bit == 8) {
        bit = 0;
        ++pos;
      }
      if (b) return q;
      ++q;
    }
  }

  void align() {
    if (bit) {
      bit = 0;
      ++pos;
    }
  }
};

uint8_t crc8(const uint8_t* data, size_t n) {  // poly 0x07, init 0
  uint8_t crc = 0;
  for (size_t i = 0; i < n; ++i) {
    crc ^= data[i];
    for (int b = 0; b < 8; ++b)
      crc = (crc & 0x80) ? (uint8_t)((crc << 1) ^ 0x07) : (uint8_t)(crc << 1);
  }
  return crc;
}

uint16_t crc16_flac(const uint8_t* data, size_t n) {  // poly 0x8005, init 0
  uint16_t crc = 0;
  for (size_t i = 0; i < n; ++i) {
    crc ^= (uint16_t)(data[i] << 8);
    for (int b = 0; b < 8; ++b)
      crc = (crc & 0x8000) ? (uint16_t)((crc << 1) ^ 0x8005)
                           : (uint16_t)(crc << 1);
  }
  return crc;
}

// UTF-8-style coded number (frame/sample index, up to 36 bits)
uint64_t read_coded_number(BitReader& br) {
  const uint32_t b0 = (uint32_t)br.read_bits(8);
  int n_extra;
  uint64_t v;
  if ((b0 & 0x80) == 0) return b0;
  if ((b0 & 0xE0) == 0xC0) { v = b0 & 0x1F; n_extra = 1; }
  else if ((b0 & 0xF0) == 0xE0) { v = b0 & 0x0F; n_extra = 2; }
  else if ((b0 & 0xF8) == 0xF0) { v = b0 & 0x07; n_extra = 3; }
  else if ((b0 & 0xFC) == 0xF8) { v = b0 & 0x03; n_extra = 4; }
  else if ((b0 & 0xFE) == 0xFC) { v = b0 & 0x01; n_extra = 5; }
  else if (b0 == 0xFE) { v = 0; n_extra = 6; }
  else { br.ok = false; return 0; }
  for (int i = 0; i < n_extra; ++i) {
    const uint32_t b = (uint32_t)br.read_bits(8);
    if ((b & 0xC0) != 0x80) {
      br.ok = false;
      return 0;
    }
    v = (v << 6) | (b & 0x3F);
  }
  return v;
}

// Partitioned rice residual into out[order..blocksize)
bool decode_residual(BitReader& br, int order, int blocksize, int64_t* out) {
  const int method = (int)br.read_bits(2);
  if (method > 1) return false;
  const int po = (int)br.read_bits(4);
  const int parts = 1 << po;
  if (blocksize % parts != 0) return false;
  const int per_part = blocksize >> po;
  const int param_bits = method == 0 ? 4 : 5;
  const uint32_t escape = method == 0 ? 15 : 31;
  int idx = order;
  for (int p = 0; p < parts; ++p) {
    const int n = per_part - (p == 0 ? order : 0);
    if (n < 0) return false;
    const uint32_t param = (uint32_t)br.read_bits(param_bits);
    if (param == escape) {
      const int rbits = (int)br.read_bits(5);
      for (int i = 0; i < n; ++i) out[idx++] = br.read_signed(rbits);
    } else {
      for (int i = 0; i < n; ++i) {
        const uint64_t q = br.read_unary();
        const uint64_t u = (q << param) | br.read_bits((int)param);
        out[idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
      }
    }
    if (!br.ok) return false;
  }
  return true;
}

bool decode_subframe(BitReader& br, int bps, int blocksize,
                     std::vector<int64_t>& out) {
  if (br.read_bits(1) != 0) return false;  // padding bit
  const int type = (int)br.read_bits(6);
  int wasted = 0;
  if (br.read_bits(1)) wasted = (int)br.read_unary() + 1;
  bps -= wasted;
  if (bps <= 0 || bps > 33) return false;
  out.assign((size_t)blocksize, 0);

  if (type == 0) {  // CONSTANT
    const int64_t v = br.read_signed(bps);
    for (int i = 0; i < blocksize; ++i) out[i] = v;
  } else if (type == 1) {  // VERBATIM
    for (int i = 0; i < blocksize; ++i) out[i] = br.read_signed(bps);
  } else if (type >= 8 && type <= 12) {  // FIXED, order = type & 7
    const int order = type & 7;
    if (order > blocksize) return false;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    if (!decode_residual(br, order, blocksize, out.data())) return false;
    static const int coef[5][4] = {{0, 0, 0, 0},
                                   {1, 0, 0, 0},
                                   {2, -1, 0, 0},
                                   {3, -3, 1, 0},
                                   {4, -6, 4, -1}};
    for (int i = order; i < blocksize; ++i) {
      int64_t acc = out[i];
      for (int j = 0; j < order; ++j) acc += coef[order][j] * out[i - 1 - j];
      out[i] = acc;
    }
  } else if (type >= 32) {  // LPC, order = (type & 31) + 1
    const int order = (type & 31) + 1;
    if (order > blocksize) return false;
    for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
    const int precision = (int)br.read_bits(4) + 1;
    if (precision == 16) return false;  // 0b1111 is invalid
    const int shift = (int)br.read_signed(5);
    if (shift < 0) return false;
    int64_t coef[32];
    for (int i = 0; i < order; ++i) coef[i] = br.read_signed(precision);
    if (!decode_residual(br, order, blocksize, out.data())) return false;
    for (int i = order; i < blocksize; ++i) {
      int64_t acc = 0;
      for (int j = 0; j < order; ++j) acc += coef[j] * out[i - 1 - j];
      out[i] += acc >> shift;  // arithmetic shift: floor
    }
  } else {
    return false;  // reserved type
  }
  if (wasted)
    for (int i = 0; i < blocksize; ++i) out[i] <<= wasted;
  return br.ok;
}

WavData decode_flac(const uint8_t* data, size_t size) {
  WavData out;
  if (size < 42 || std::memcmp(data, "fLaC", 4) != 0) {
    out.error = "not a FLAC file";
    return out;
  }
  // --- metadata blocks ---
  size_t pos = 4;
  int channels = 0, bps = 0;
  uint64_t total_samples = 0;
  bool have_streaminfo = false, last = false;
  while (!last && pos + 4 <= size) {
    const uint8_t h = data[pos];
    last = (h & 0x80) != 0;
    const int type = h & 0x7F;
    const uint32_t len = ((uint32_t)data[pos + 1] << 16) |
                         ((uint32_t)data[pos + 2] << 8) | data[pos + 3];
    pos += 4;
    if (pos + len > size) {
      out.error = "truncated metadata block";
      return out;
    }
    if (type == 0 && len >= 34) {  // STREAMINFO
      const uint8_t* s = data + pos;
      out.sample_rate =
          (int)(((uint32_t)s[10] << 12) | ((uint32_t)s[11] << 4) | (s[12] >> 4));
      channels = ((s[12] >> 1) & 0x7) + 1;
      bps = (int)(((s[12] & 1) << 4) | (s[13] >> 4)) + 1;
      total_samples = ((uint64_t)(s[13] & 0x0F) << 32) |
                      ((uint64_t)s[14] << 24) | ((uint64_t)s[15] << 16) |
                      ((uint64_t)s[16] << 8) | s[17];
      have_streaminfo = true;
    }
    pos += len;
  }
  if (!have_streaminfo || channels < 1 || channels > 8 ||
      out.sample_rate <= 0) {
    out.error = "missing/bad STREAMINFO";
    return out;
  }
  if (bps > 26) {  // side channel must fit an int64 pipeline comfortably
    out.error = "unsupported bits-per-sample";
    return out;
  }
  // Bounded reserve: total_samples is a 36-bit field from the file — a
  // corrupt/hostile value must not drive a huge allocation. The vector
  // still grows to the true decoded size.
  if (total_samples) {
    const uint64_t cap = size * 4;  // decoded floats rarely exceed 4x input
    out.samples.reserve((size_t)(total_samples < cap ? total_samples : cap));
  }
  const double scale = 1.0 / (double)(1LL << (bps - 1)) / channels;

  // --- frames ---
  BitReader br(data, size);
  br.pos = pos;
  std::vector<std::vector<int64_t>> ch((size_t)channels);
  while ((total_samples == 0 || out.samples.size() < total_samples) &&
         br.pos + 2 <= size) {
    const size_t frame_start = br.pos;
    if (br.read_bits(14) != 0x3FFE) {
      // allow trailing zero padding after the last frame
      bool all_zero = true;
      for (size_t i = frame_start; i < size && all_zero; ++i)
        all_zero = data[i] == 0;
      if (all_zero && total_samples == 0) break;
      out.error = "lost frame sync";
      return out;
    }
    br.read_bits(1);  // reserved
    br.read_bits(1);  // blocking strategy
    const int bs_code = (int)br.read_bits(4);
    const int sr_code = (int)br.read_bits(4);
    const int ch_code = (int)br.read_bits(4);
    const int ss_code = (int)br.read_bits(3);
    br.read_bits(1);  // reserved
    read_coded_number(br);
    int blocksize;
    switch (bs_code) {
      case 0: out.error = "reserved block size"; return out;
      case 1: blocksize = 192; break;
      case 6: blocksize = (int)br.read_bits(8) + 1; break;
      case 7: blocksize = (int)br.read_bits(16) + 1; break;
      default:
        blocksize = (bs_code < 6) ? 576 << (bs_code - 2)
                                  : 256 << (bs_code - 8);
    }
    static const int kRates[12] = {0,     88200, 176400, 192000, 8000, 16000,
                                   22050, 24000, 32000,  44100,  48000, 96000};
    int frame_sr = out.sample_rate;
    if (sr_code >= 1 && sr_code <= 11) frame_sr = kRates[sr_code];
    else if (sr_code == 12) frame_sr = (int)br.read_bits(8) * 1000;
    else if (sr_code == 13) frame_sr = (int)br.read_bits(16);
    else if (sr_code == 14) frame_sr = (int)br.read_bits(16) * 10;
    else if (sr_code == 15) { out.error = "invalid sample-rate code"; return out; }
    if (frame_sr != out.sample_rate) {
      out.error = "frame/stream sample-rate mismatch";
      return out;
    }
    static const int kSizes[8] = {0, 8, 12, -1, 16, 20, 24, 32};
    int frame_bps = bps;
    if (ss_code != 0) {
      frame_bps = kSizes[ss_code];
      if (frame_bps != bps) {
        out.error = "frame/stream sample-size mismatch";
        return out;
      }
    }
    int frame_channels;
    int mode = 0;  // 0 independent, 1 left/side, 2 right/side, 3 mid/side
    if (ch_code <= 7) {
      frame_channels = ch_code + 1;
    } else if (ch_code <= 10) {
      frame_channels = 2;
      mode = ch_code - 7;
    } else {
      out.error = "reserved channel assignment";
      return out;
    }
    if (frame_channels != channels) {
      out.error = "frame/stream channel mismatch";
      return out;
    }
    const uint8_t expect_crc8 = (uint8_t)br.read_bits(8);
    if (!br.ok) {
      out.error = "truncated frame header";
      return out;
    }
    if (crc8(data + frame_start, br.pos - 1 - frame_start) != expect_crc8) {
      out.error = "frame header CRC-8 mismatch";
      return out;
    }

    for (int c = 0; c < channels; ++c) {
      int sub_bps = bps;
      if ((mode == 1 && c == 1) || (mode == 2 && c == 0) ||
          (mode == 3 && c == 1))
        sub_bps += 1;  // the side channel carries one extra bit
      if (!decode_subframe(br, sub_bps, blocksize, ch[(size_t)c])) {
        out.error = br.ok ? "bad subframe" : "truncated subframe";
        return out;
      }
    }
    br.align();
    const size_t crc_end = br.pos;
    const uint16_t expect_crc16 = (uint16_t)br.read_bits(16);
    if (!br.ok) {
      out.error = "truncated frame footer";
      return out;
    }
    if (crc16_flac(data + frame_start, crc_end - frame_start) != expect_crc16) {
      out.error = "frame CRC-16 mismatch";
      return out;
    }

    // stereo decorrelation
    if (mode == 1) {  // left/side: right = left - side
      for (int i = 0; i < blocksize; ++i) ch[1][i] = ch[0][i] - ch[1][i];
    } else if (mode == 2) {  // right/side: stored (side, right)
      for (int i = 0; i < blocksize; ++i) ch[0][i] = ch[1][i] + ch[0][i];
    } else if (mode == 3) {  // mid/side
      for (int i = 0; i < blocksize; ++i) {
        const int64_t side = ch[1][i];
        const int64_t m2 = (ch[0][i] << 1) | (side & 1);
        ch[0][i] = (m2 + side) >> 1;
        ch[1][i] = (m2 - side) >> 1;
      }
    }
    if (out.samples.size() > (1u << 28)) {  // ~3.7 h at 20 kHz: a corrupt
      out.error = "stream too long";        // or hostile stream, not audio
      return out;
    }
    int take = blocksize;
    if (total_samples &&
        out.samples.size() + (size_t)blocksize > total_samples)
      take = (int)(total_samples - out.samples.size());
    for (int i = 0; i < take; ++i) {
      int64_t acc = 0;
      for (int c = 0; c < channels; ++c) acc += ch[(size_t)c][i];
      out.samples.push_back((float)(acc * scale));
    }
  }
  if (total_samples && out.samples.size() < total_samples) {
    out.error = "stream ended before total_samples";
    return out;
  }
  return out;
}

// ---------------------------------------------------------------------------
// Polyphase resampling (scipy.signal.resample_poly-compatible filter design:
// Kaiser window beta=5.0, 10*max(up,down) taps each side of center)
// ---------------------------------------------------------------------------

double bessel_i0(double x) {
  // series expansion; converges quickly for the beta values used here
  double sum = 1.0, term = 1.0;
  const double x2 = x * x / 4.0;
  for (int k = 1; k < 64; ++k) {
    term *= x2 / (k * (double)k);
    sum += term;
    if (term < 1e-16 * sum) break;
  }
  return sum;
}

std::vector<double> design_lowpass(int up, int down, double beta = 5.0) {
  const int max_rate = up > down ? up : down;
  const double f_c = 1.0 / (2.0 * max_rate);  // cutoff in normalized freq
  const int half_len = 10 * max_rate;
  const int n = 2 * half_len + 1;
  std::vector<double> h(n);
  const double i0b = bessel_i0(beta);
  for (int i = 0; i < n; ++i) {
    const double m = i - half_len;
    // sinc lowpass
    const double x = 2.0 * f_c * m;
    double s = (m == 0) ? 2.0 * f_c : std::sin(M_PI * x) / (M_PI * m);
    // kaiser window
    const double r = 2.0 * i / (n - 1) - 1.0;
    const double w = bessel_i0(beta * std::sqrt(1.0 - r * r)) / i0b;
    h[i] = s * w * up;  // gain compensation for zero-stuffing
  }
  return h;
}

struct PolyphaseFilter {
  // taps reorganized per phase for contiguous access:
  // phases[p] = {first_x_offset_rel_center, contiguous taps (reversed in x)}
  int up = 0, down = 0, taps_per_phase = 0;
  std::vector<float> taps;       // [up, taps_per_phase]
  std::vector<int> first_rel;    // x index of tap 0 relative to center/up
};

const PolyphaseFilter& cached_filter(int up, int down) {
  // GIL-released callers run concurrently: guard the cache with a mutex and
  // use a deque so returned references stay valid across later insertions.
  static std::mutex mu;
  static std::deque<PolyphaseFilter> cache;
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& f : cache) {
    if (f.up == up && f.down == down) return f;
  }
  const std::vector<double> h = design_lowpass(up, down);
  const int half_len = (int)(h.size() / 2);
  PolyphaseFilter f;
  f.up = up;
  f.down = down;
  f.taps_per_phase = (int)(h.size() / up) + 2;
  f.taps.assign((size_t)up * f.taps_per_phase, 0.0f);
  f.first_rel.assign(up, 0);
  for (int p = 0; p < up; ++p) {
    // Output with phase p has upsampled center c with c % up == p... we use
    // phase = center % up; filter index k covers j0 + k where
    // j0 = center - half_len; j must be multiple of up.
    // k0 = (up - ((center - half_len) % up)) % up, independent of center
    // except through p:
    int64_t j0_mod = ((int64_t)p - half_len) % up;
    if (j0_mod < 0) j0_mod += up;
    int k0 = (int)((up - j0_mod) % up);
    f.first_rel[p] = (int)((p - half_len + k0) / up)
        - (int)((p - half_len + k0) % up != 0 ? 1 : 0);
    // recompute exactly: xi_first = floor((center - half_len + k0)/up)
    // center = m*up + p for integer m => xi_first = m + (p - half_len + k0)/up
    f.first_rel[p] = (int)std::floor(((double)p - half_len + k0) / up);
    int i = 0;
    for (int k = k0; k < (int)h.size(); k += up, ++i) {
      f.taps[(size_t)p * f.taps_per_phase + i] = (float)h[(size_t)k];
    }
  }
  cache.push_back(std::move(f));
  return cache.back();
}

std::vector<float> resample_poly(const std::vector<float>& x, int up, int down) {
  if (up == down) return x;
  const PolyphaseFilter& f = cached_filter(up, down);
  const int64_t n_in = (int64_t)x.size();
  const int64_t n_out = (n_in * up + down - 1) / down;
  std::vector<float> y((size_t)n_out);
  for (int64_t t = 0; t < n_out; ++t) {
    const int64_t center = t * down;
    const int p = (int)(center % up);
    const int64_t m = center / up;
    const float* taps = &f.taps[(size_t)p * f.taps_per_phase];
    int64_t xi = m + f.first_rel[p];
    float acc = 0.0f;
    int i = 0;
    // clip leading out-of-range input indices
    if (xi < 0) {
      i = (int)(-xi);
      xi = 0;
    }
    const int i_end = (int)std::min<int64_t>(f.taps_per_phase,
                                             i + (n_in - xi));
    for (; i < i_end; ++i, ++xi) acc += taps[i] * x[(size_t)xi];
    y[(size_t)t] = acc;
  }
  return y;
}

// ---------------------------------------------------------------------------
// Framewise RMS (center-padded, librosa.feature.rms convention)
// ---------------------------------------------------------------------------

std::vector<float> rms_frames(const float* x, int64_t n, int frame_length,
                              int hop_length) {
  const int pad = frame_length / 2;
  const int64_t padded = n + 2 * pad;
  const int64_t n_frames = (padded >= frame_length)
                               ? 1 + (padded - frame_length) / hop_length
                               : 0;
  std::vector<float> out((size_t)n_frames);
  for (int64_t f = 0; f < n_frames; ++f) {
    double acc = 0.0;
    const int64_t start = f * hop_length - pad;
    for (int i = 0; i < frame_length; ++i) {
      const int64_t idx = start + i;
      if (idx >= 0 && idx < n) {
        const double v = x[idx];
        acc += v * v;
      }
    }
    out[(size_t)f] = (float)std::sqrt(acc / frame_length);
  }
  return out;
}

// ---------------------------------------------------------------------------
// C interface. A call returns 0 on success and fills a malloc'd float
// buffer (free it with nst_free); on failure it writes a NUL-terminated
// message into err[0:err_len] and returns -1, or errno (> 0) when the
// file cannot be opened.
// ---------------------------------------------------------------------------

float* copy_out(const std::vector<float>& v) {
  float* p = (float*)std::malloc(std::max<size_t>(v.size(), 1) * sizeof(float));
  if (p && !v.empty()) std::memcpy(p, v.data(), v.size() * sizeof(float));
  return p;
}

void set_error(char* err, int err_len, const std::string& msg) {
  if (err && err_len > 0) {
    std::snprintf(err, (size_t)err_len, "%s", msg.c_str());
  }
}

}  // namespace

extern "C" {

int nst_load_wav(const char* path, int target_sr, float** out, int64_t* n,
                 int* sample_rate, char* err, int err_len) {
  WavData wav;
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    const int code = errno ? errno : EIO;
    set_error(err, err_len, std::string(path) + ": cannot open file");
    return code;
  }
  {
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::vector<uint8_t> buf(size > 0 ? (size_t)size : 0);
    size_t got = buf.empty() ? 0 : std::fread(buf.data(), 1, buf.size(), f);
    std::fclose(f);
    if (got >= 4 && std::memcmp(buf.data(), "fLaC", 4) == 0) {
      wav = decode_flac(buf.data(), got);
    } else {
      wav = decode_wav(buf.data(), got);
    }
    if (wav.error.empty() && target_sr > 0 && wav.sample_rate != target_sr) {
      // reduce up/down by gcd
      int a = target_sr, b = wav.sample_rate;
      while (b) { int t = a % b; a = b; b = t; }
      wav.samples = resample_poly(wav.samples, target_sr / a,
                                  wav.sample_rate / a);
      wav.sample_rate = target_sr;
    }
  }
  if (!wav.error.empty()) {
    set_error(err, err_len, std::string(path) + ": " + wav.error);
    return -1;
  }
  *out = copy_out(wav.samples);
  if (!*out) {
    set_error(err, err_len, "out of memory");
    return -1;
  }
  *n = (int64_t)wav.samples.size();
  *sample_rate = wav.sample_rate;
  return 0;
}

int nst_rms_frames(const float* x, int64_t n, int frame_length, int hop_length,
                   float** out, int64_t* n_out, char* err, int err_len) {
  if (frame_length <= 0 || hop_length <= 0) {
    set_error(err, err_len, "frame_length and hop_length must be positive");
    return -1;
  }
  const std::vector<float> r = rms_frames(x, n, frame_length, hop_length);
  *out = copy_out(r);
  if (!*out) {
    set_error(err, err_len, "out of memory");
    return -1;
  }
  *n_out = (int64_t)r.size();
  return 0;
}

void nst_free(float* p) { std::free(p); }

}  // extern "C"
