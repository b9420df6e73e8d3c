// The head widths the kernels of flash_fwd.cu, flash_bwd.cu and
// paged_decode.cu take, and the padded width each body is built for.
#pragma once

namespace {

// d_head (a multiple of 16 from 16 to 256) rounded up to the width a body
// is built for: 16, 32, 64, 128 or 256; 0 for other widths. The kernels
// read and write the real d_head in memory and fill the columns past it
// with zeros: zero columns of Q and K leave the scores as they are, zero
// columns of V and dO give zero output columns, which are not stored. A
// width is always past half its padded width, so the first half of a
// body's columns is always stored.
inline int padded_width(int d) {
  if (d < 16 || d > 256 || d % 16 != 0) return 0;
  int pad = 16;
  while (pad < d) pad *= 2;
  return pad;
}

}  // namespace
