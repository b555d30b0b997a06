// Native host-pipeline routines of the vqcpcb_tpu_torch data layer (a copy
// of the JAX package's vqcpcb_tpu/native/tokenizer.cpp).
//
// No training or sampling step runs this code: it speeds up the corpus
// preprocessing (tick-grid tokenization with slur encoding and window
// extraction, semantics of reference chorale_dataset.py:297-321,418-470) and
// the per-batch same-sequence negatives. vqcpcb_tpu_torch/native/__init__.py
// builds it with g++ at first use and binds it through ctypes; the NumPy
// paths of vqcpcb_tpu_torch/data stay as the VQCPCB_NATIVE=0 route, and the
// tests hold both equal bit for bit.

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Tick-grid articulation loop for one part (chorale_dataset.py:297-321).
//   offsets:      event onsets in beats, ascending          [num_events]
//   token_index:  vocab index of each event's (possibly OOR-clamped) name
//   length:       number of ticks to emit
//   subdivision:  ticks per beat
//   offset_start: window start in beats
//   slur_index:   vocab index of the slur symbol
//   out:          int32 [length]
void part_to_ticks(const double* offsets,
                   const int32_t* token_index,
                   int64_t num_events,
                   int64_t length,
                   int64_t subdivision,
                   double offset_start,
                   int32_t slur_index,
                   int32_t* out) {
  if (num_events == 0) {
    for (int64_t i = 0; i < length; ++i) out[i] = slur_index;
    return;
  }
  int64_t j = 0;
  int64_t i = 0;
  bool is_articulated = true;
  while (i < length) {
    if (j < num_events - 1) {
      if (offsets[j + 1] > static_cast<double>(i) / subdivision + offset_start) {
        out[i] = is_articulated ? token_index[j] : slur_index;
        ++i;
        is_articulated = false;
      } else {
        ++j;
        is_articulated = true;
      }
    } else {
      out[i] = is_articulated ? token_index[j] : slur_index;
      ++i;
      is_articulated = false;
    }
  }
}

// Window extraction with START/END/PAD edge padding
// (chorale_dataset.py:418-470). Extracts num_windows windows at given
// start_ticks from a (num_voices, length) grid into
// (num_windows, num_voices, window_len).
void extract_windows(const int32_t* grid,
                     int64_t num_voices,
                     int64_t length,
                     const int64_t* start_ticks,
                     int64_t num_windows,
                     int64_t window_len,
                     const int32_t* start_symbols,   // [num_voices]
                     const int32_t* end_symbols,     // [num_voices]
                     const int32_t* pad_symbols,     // [num_voices]
                     int32_t* out) {
  for (int64_t w = 0; w < num_windows; ++w) {
    int64_t s0 = start_ticks[w];
    for (int64_t v = 0; v < num_voices; ++v) {
      int32_t* dst = out + (w * num_voices + v) * window_len;
      const int32_t* src = grid + v * length;
      for (int64_t t = 0; t < window_len; ++t) {
        int64_t tick = s0 + t;
        if (tick < 0) {
          dst[t] = (tick == -1) ? start_symbols[v] : pad_symbols[v];
        } else if (tick >= length) {
          dst[t] = (tick == length) ? end_symbols[v] : pad_symbols[v];
        } else {
          dst[t] = src[tick];
        }
      }
    }
  }
}

// Same-sequence negative assembly (bach_cpc_dataloader.py:159-181):
// x_left (B, L*tb, V) and x_right (B, R*tb, V) row-major ->
// negatives (B, L+R-1, R, tb, V): for each prediction step k, all blocks of
// the excerpt except right-block k.
void build_negatives_same_seq(const int32_t* x_left,
                              const int32_t* x_right,
                              int64_t batch,
                              int64_t blocks_left,
                              int64_t blocks_right,
                              int64_t ticks_block,
                              int64_t voices,
                              int32_t* out) {
  const int64_t block_elems = ticks_block * voices;
  const int64_t num_neg = blocks_left + blocks_right - 1;
  for (int64_t b = 0; b < batch; ++b) {
    const int32_t* left = x_left + b * blocks_left * block_elems;
    const int32_t* right = x_right + b * blocks_right * block_elems;
    for (int64_t k = 0; k < blocks_right; ++k) {
      // negatives for step k, laid out at out[b, n, k]
      int64_t n = 0;
      for (int64_t bl = 0; bl < blocks_left; ++bl, ++n) {
        std::memcpy(out + ((b * num_neg + n) * blocks_right + k) * block_elems,
                    left + bl * block_elems,
                    block_elems * sizeof(int32_t));
      }
      for (int64_t br = 0; br < blocks_right; ++br) {
        if (br == k) continue;
        std::memcpy(out + ((b * num_neg + n) * blocks_right + k) * block_elems,
                    right + br * block_elems,
                    block_elems * sizeof(int32_t));
        ++n;
      }
    }
  }
}

}  // extern "C"
