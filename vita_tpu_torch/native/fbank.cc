// Kaldi-compatible log-mel fbank, C++ (host-side audio frontend).
//
// Native equivalent of the torchaudio/Kaldi C++ fbank the reference relies
// on (vita/model/multimodal_encoder/whale/init_model.py:35-60). Exact same
// pipeline as vita_tpu/data/audio.py's numpy implementation (which is the
// parity spec and test oracle): snip-edges framing, optional dither, DC
// removal, preemphasis 0.97, Povey window, 512-pt FFT power spectrum,
// triangular mel banks (20 Hz..Nyquist), natural-log with float-eps floor.
//
// Build: g++ -O3 -shared -fPIC -o libvitafbank.so fbank.cc
// Exposed via ctypes (vita_tpu/native/__init__.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

// iterative radix-2 complex FFT, n must be a power of two
void fft(std::vector<double>& re, std::vector<double>& im) {
  const size_t n = re.size();
  // bit reversal
  for (size_t i = 1, j = 0; i < n; ++i) {
    size_t bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) {
      std::swap(re[i], re[j]);
      std::swap(im[i], im[j]);
    }
  }
  for (size_t len = 2; len <= n; len <<= 1) {
    const double ang = -2.0 * kPi / static_cast<double>(len);
    const double wr = std::cos(ang), wi = std::sin(ang);
    for (size_t i = 0; i < n; i += len) {
      double cr = 1.0, ci = 0.0;
      for (size_t k = 0; k < len / 2; ++k) {
        const double ur = re[i + k], ui = im[i + k];
        const double vr = re[i + k + len / 2] * cr - im[i + k + len / 2] * ci;
        const double vi = re[i + k + len / 2] * ci + im[i + k + len / 2] * cr;
        re[i + k] = ur + vr;
        im[i + k] = ui + vi;
        re[i + k + len / 2] = ur - vr;
        im[i + k + len / 2] = ui - vi;
        const double ncr = cr * wr - ci * wi;
        ci = cr * wi + ci * wr;
        cr = ncr;
      }
    }
  }
}

double mel_scale(double freq) { return 1127.0 * std::log(1.0 + freq / 700.0); }

}  // namespace

extern "C" {

// Number of frames fbank will produce for n_samples (snip_edges).
int32_t vita_fbank_num_frames(int32_t n_samples, int32_t sample_rate,
                              double frame_length_ms, double frame_shift_ms) {
  const int win = static_cast<int>(frame_length_ms * sample_rate / 1000.0);
  const int shift = static_cast<int>(frame_shift_ms * sample_rate / 1000.0);
  if (n_samples < win) return 0;
  return 1 + (n_samples - win) / shift;
}

// wav: float samples in [-1, 1] (scaled x32768 internally like the
// reference). out: [num_frames x num_bins] row-major. Returns num_frames,
// or -1 on bad args.
int32_t vita_fbank(const float* wav, int32_t n_samples, int32_t sample_rate,
                   int32_t num_bins, double frame_length_ms,
                   double frame_shift_ms, double dither, double preemph,
                   double low_freq, double high_freq, uint64_t seed,
                   float* out) {
  if (!wav || !out || num_bins <= 0 || sample_rate <= 0) return -1;
  const int win = static_cast<int>(frame_length_ms * sample_rate / 1000.0);
  const int shift = static_cast<int>(frame_shift_ms * sample_rate / 1000.0);
  const int n_frames =
      vita_fbank_num_frames(n_samples, sample_rate, frame_length_ms, frame_shift_ms);
  if (n_frames <= 0) return 0;

  int fft_size = 1;
  while (fft_size < win) fft_size <<= 1;
  const int n_fft_bins = fft_size / 2;

  // Povey window
  std::vector<double> window(win);
  for (int i = 0; i < win; ++i) {
    window[i] = std::pow(0.5 - 0.5 * std::cos(2.0 * kPi * i / (win - 1)), 0.85);
  }

  // mel banks [num_bins x n_fft_bins]
  const double nyquist = 0.5 * sample_rate;
  const double hf = high_freq <= 0.0 ? nyquist + high_freq : high_freq;
  const double mel_low = mel_scale(low_freq), mel_high = mel_scale(hf);
  const double mel_delta = (mel_high - mel_low) / (num_bins + 1);
  const double bin_width = static_cast<double>(sample_rate) / fft_size;
  std::vector<double> banks(static_cast<size_t>(num_bins) * n_fft_bins, 0.0);
  for (int b = 0; b < num_bins; ++b) {
    const double left = mel_low + b * mel_delta;
    const double center = left + mel_delta;
    const double right = center + mel_delta;
    for (int f = 0; f < n_fft_bins; ++f) {
      const double mel = mel_scale(f * bin_width);
      const double up = (mel - left) / (center - left);
      const double down = (right - mel) / (right - center);
      const double w = std::min(up, down);
      if (w > 0.0) banks[static_cast<size_t>(b) * n_fft_bins + f] = w;
    }
  }

  std::mt19937_64 rng(seed);
  std::normal_distribution<double> gauss(0.0, 1.0);
  const double eps = 1.1920928955078125e-07;  // float32 eps

  std::vector<double> frame(win), re(fft_size), im(fft_size), power(n_fft_bins);
  for (int t = 0; t < n_frames; ++t) {
    const float* src = wav + static_cast<size_t>(t) * shift;
    double mean = 0.0;
    for (int i = 0; i < win; ++i) {
      frame[i] = static_cast<double>(src[i]) * 32768.0;
      if (dither != 0.0) frame[i] += dither * gauss(rng);
      mean += frame[i];
    }
    mean /= win;
    for (int i = 0; i < win; ++i) frame[i] -= mean;  // remove DC
    // preemphasis (first sample uses itself, Kaldi convention)
    for (int i = win - 1; i > 0; --i) frame[i] -= preemph * frame[i - 1];
    frame[0] -= preemph * frame[0];

    for (int i = 0; i < win; ++i) {
      re[i] = frame[i] * window[i];
      im[i] = 0.0;
    }
    std::fill(re.begin() + win, re.end(), 0.0);
    std::fill(im.begin() + win, im.end(), 0.0);
    fft(re, im);
    for (int f = 0; f < n_fft_bins; ++f) power[f] = re[f] * re[f] + im[f] * im[f];

    float* dst = out + static_cast<size_t>(t) * num_bins;
    for (int b = 0; b < num_bins; ++b) {
      const double* bank = banks.data() + static_cast<size_t>(b) * n_fft_bins;
      double acc = 0.0;
      for (int f = 0; f < n_fft_bins; ++f) acc += power[f] * bank[f];
      dst[b] = static_cast<float>(std::log(std::max(acc, eps)));
    }
  }
  return n_frames;
}

}  // extern "C"
