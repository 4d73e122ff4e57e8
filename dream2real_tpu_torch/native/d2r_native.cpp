// The port's native runtime: PNG codec + RGB-D dataset ingest (a copy of
// the JAX package's d2r_native.cpp, so the port builds it from its own tree).
//
// A plain C ABI consumed via ctypes (dream2real_tpu_torch/native):
//   - PNG decode for the formats the pipeline uses: 8-bit RGB/RGBA and
//     8/16-bit grayscale (depth maps are 16-bit millimetre PNGs),
//     non-interlaced;
//   - PNG encode for the same formats (mask/artifact writes);
//   - batch RGB-D dataset ingest (decode rgb_%04d.png + depth_%04d.png into
//     caller-provided buffers without bouncing through Python per frame).
//
// Built at first use by dream2real_tpu_torch/build.py::load_native (the host
// C++ compiler, -O3 -shared, links zlib only).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

constexpr uint8_t kPngSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

struct PngHeader {
  uint32_t width = 0, height = 0;
  int bit_depth = 0, color_type = 0, channels = 0, interlace = 0;
};

int channels_for_color_type(int ct) {
  switch (ct) {
    case 0: return 1;  // gray
    case 2: return 3;  // rgb
    case 4: return 2;  // gray+alpha
    case 6: return 4;  // rgba
    default: return 0; // palette unsupported
  }
}

// Parse chunks; fill header; concatenate IDAT payloads.
int parse_png(const uint8_t* buf, long n, PngHeader* hdr,
              std::vector<uint8_t>* idat) {
  if (n < 8 || memcmp(buf, kPngSig, 8) != 0) return -1;
  long off = 8;
  bool saw_ihdr = false;
  while (off + 12 <= n) {
    uint32_t len = be32(buf + off);
    const uint8_t* type = buf + off + 4;
    const uint8_t* data = buf + off + 8;
    if (off + 12 + long(len) > n) return -2;
    if (memcmp(type, "IHDR", 4) == 0) {
      if (len < 13) return -3;
      hdr->width = be32(data);
      hdr->height = be32(data + 4);
      hdr->bit_depth = data[8];
      hdr->color_type = data[9];
      hdr->interlace = data[12];
      hdr->channels = channels_for_color_type(hdr->color_type);
      if (hdr->channels == 0) return -4;           // palette etc.
      if (hdr->interlace != 0) return -5;          // Adam7 unsupported
      if (hdr->bit_depth != 8 && hdr->bit_depth != 16) return -6;
      saw_ihdr = true;
    } else if (memcmp(type, "IDAT", 4) == 0) {
      idat->insert(idat->end(), data, data + len);
    } else if (memcmp(type, "IEND", 4) == 0) {
      break;
    }
    off += 12 + len;
  }
  return saw_ihdr ? 0 : -7;
}

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Undo PNG scanline filters in place over the raw inflate output.
int unfilter(std::vector<uint8_t>& raw, const PngHeader& h,
             std::vector<uint8_t>* out) {
  const size_t bpp = size_t(h.channels) * (h.bit_depth / 8);
  const size_t stride = size_t(h.width) * bpp;
  if (raw.size() < h.height * (stride + 1)) return -8;
  out->resize(size_t(h.height) * stride);
  const uint8_t* prev = nullptr;
  for (uint32_t y = 0; y < h.height; ++y) {
    const uint8_t* in = raw.data() + size_t(y) * (stride + 1);
    uint8_t filter = in[0];
    ++in;
    uint8_t* cur = out->data() + size_t(y) * stride;
    switch (filter) {
      case 0:
        memcpy(cur, in, stride);
        break;
      case 1:  // Sub
        for (size_t i = 0; i < stride; ++i)
          cur[i] = in[i] + (i >= bpp ? cur[i - bpp] : 0);
        break;
      case 2:  // Up
        for (size_t i = 0; i < stride; ++i)
          cur[i] = in[i] + (prev ? prev[i] : 0);
        break;
      case 3:  // Average
        for (size_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          cur[i] = in[i] + uint8_t((a + b) >> 1);
        }
        break;
      case 4:  // Paeth
        for (size_t i = 0; i < stride; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          int b = prev ? prev[i] : 0;
          int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          cur[i] = in[i] + uint8_t(paeth(a, b, c));
        }
        break;
      default:
        return -9;
    }
    prev = cur;
  }
  return 0;
}

int decode_png_impl(const uint8_t* buf, long n, PngHeader* h,
                    std::vector<uint8_t>* pixels) {
  std::vector<uint8_t> idat;
  int rc = parse_png(buf, n, h, &idat);
  if (rc != 0) return rc;
  const size_t bpp = size_t(h->channels) * (h->bit_depth / 8);
  const size_t raw_size = size_t(h->height) * (size_t(h->width) * bpp + 1);
  std::vector<uint8_t> raw(raw_size);
  uLongf dst_len = raw_size;
  if (uncompress(raw.data(), &dst_len, idat.data(), idat.size()) != Z_OK ||
      dst_len != raw_size)
    return -10;
  rc = unfilter(raw, *h, pixels);
  if (rc != 0) return rc;
  if (h->bit_depth == 16) {  // big-endian -> host little-endian u16
    for (size_t i = 0; i + 1 < pixels->size(); i += 2)
      std::swap((*pixels)[i], (*pixels)[i + 1]);
  }
  return 0;
}

std::vector<uint8_t> read_file(const char* path) {
  std::vector<uint8_t> out;
  FILE* f = fopen(path, "rb");
  if (!f) return out;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out.resize(n);
  if (fread(out.data(), 1, n, f) != size_t(n)) out.clear();
  fclose(f);
  return out;
}

void put_be32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back(x >> 24);
  v.push_back(x >> 16);
  v.push_back(x >> 8);
  v.push_back(x);
}

void write_chunk(std::vector<uint8_t>& out, const char* type,
                 const uint8_t* data, size_t len) {
  put_be32(out, uint32_t(len));
  size_t start = out.size();
  out.insert(out.end(), type, type + 4);
  out.insert(out.end(), data, data + len);
  uLong crc = crc32(0, out.data() + start, uInt(4 + len));
  put_be32(out, uint32_t(crc));
}

}  // namespace

extern "C" {

// Returns 0 on success. channels/bitdepth describe the decoded layout.
int d2r_png_info(const uint8_t* buf, long n, int* w, int* h, int* channels,
                 int* bitdepth) {
  PngHeader hd;
  std::vector<uint8_t> idat;
  int rc = parse_png(buf, n, &hd, &idat);
  if (rc != 0) return rc;
  *w = int(hd.width);
  *h = int(hd.height);
  *channels = hd.channels;
  *bitdepth = hd.bit_depth;
  return 0;
}

// out must hold w*h*channels*(bitdepth/8) bytes (16-bit: native-endian u16).
int d2r_png_decode(const uint8_t* buf, long n, uint8_t* out, long out_size) {
  PngHeader hd;
  std::vector<uint8_t> pixels;
  int rc = decode_png_impl(buf, n, &hd, &pixels);
  if (rc != 0) return rc;
  if (long(pixels.size()) != out_size) return -11;
  memcpy(out, pixels.data(), pixels.size());
  return 0;
}

int d2r_png_decode_file(const char* path, uint8_t* out, long out_size) {
  std::vector<uint8_t> buf = read_file(path);
  if (buf.empty()) return -12;
  return d2r_png_decode(buf.data(), long(buf.size()), out, out_size);
}

int d2r_png_info_file(const char* path, int* w, int* h, int* channels,
                      int* bitdepth) {
  std::vector<uint8_t> buf = read_file(path);
  if (buf.empty()) return -12;
  return d2r_png_info(buf.data(), long(buf.size()), w, h, channels, bitdepth);
}

// Encode (8-bit gray/rgb/rgba or 16-bit gray). Returns bytes written or <0.
long d2r_png_encode_file(const char* path, const uint8_t* pixels, int w,
                         int h, int channels, int bitdepth) {
  int color_type;
  switch (channels) {
    case 1: color_type = 0; break;
    case 3: color_type = 2; break;
    case 4: color_type = 6; break;
    default: return -1;
  }
  if (bitdepth != 8 && bitdepth != 16) return -2;
  const size_t bpp = size_t(channels) * (bitdepth / 8);
  const size_t stride = size_t(w) * bpp;
  std::vector<uint8_t> raw;
  raw.reserve(size_t(h) * (stride + 1));
  for (int y = 0; y < h; ++y) {
    raw.push_back(0);  // filter: None
    const uint8_t* row = pixels + size_t(y) * stride;
    if (bitdepth == 16) {  // host LE u16 -> big-endian
      for (size_t i = 0; i < stride; i += 2) {
        raw.push_back(row[i + 1]);
        raw.push_back(row[i]);
      }
    } else {
      raw.insert(raw.end(), row, row + stride);
    }
  }
  uLongf comp_bound = compressBound(uLong(raw.size()));
  std::vector<uint8_t> comp(comp_bound);
  if (compress2(comp.data(), &comp_bound, raw.data(), uLong(raw.size()), 6) !=
      Z_OK)
    return -3;
  comp.resize(comp_bound);

  std::vector<uint8_t> out;
  out.insert(out.end(), kPngSig, kPngSig + 8);
  uint8_t ihdr[13];
  ihdr[0] = uint8_t(w >> 24); ihdr[1] = uint8_t(w >> 16);
  ihdr[2] = uint8_t(w >> 8);  ihdr[3] = uint8_t(w);
  ihdr[4] = uint8_t(h >> 24); ihdr[5] = uint8_t(h >> 16);
  ihdr[6] = uint8_t(h >> 8);  ihdr[7] = uint8_t(h);
  ihdr[8] = uint8_t(bitdepth);
  ihdr[9] = uint8_t(color_type);
  ihdr[10] = 0; ihdr[11] = 0; ihdr[12] = 0;
  write_chunk(out, "IHDR", ihdr, 13);
  write_chunk(out, "IDAT", comp.data(), comp.size());
  write_chunk(out, "IEND", nullptr, 0);

  FILE* f = fopen(path, "wb");
  if (!f) return -4;
  size_t written = fwrite(out.data(), 1, out.size(), f);
  fclose(f);
  return written == out.size() ? long(out.size()) : -5;
}

// Batch RGB-D ingest: decode n frames of dir/images/rgb_%04d.png (8-bit RGB)
// and dir/depth/depth_%04d.png (16-bit gray, millimetres) into contiguous
// buffers. depth_out is float32 METRES (mm / 1000, data_loader.py:58).
// Returns 0 or the (negative) failing frame index - 1000.
int d2r_load_rgbd_dataset(const char* dir, int n, int height, int width,
                          uint8_t* rgb_out, float* depth_out) {
  char path[4096];
  const size_t rgb_frame = size_t(height) * width * 3;
  const size_t d_frame = size_t(height) * width;
  std::vector<uint8_t> depth_raw(d_frame * 2);
  for (int i = 0; i < n; ++i) {
    snprintf(path, sizeof(path), "%s/images/rgb_%04d.png", dir, i);
    if (d2r_png_decode_file(path, rgb_out + size_t(i) * rgb_frame,
                            long(rgb_frame)) != 0)
      return -1000 - i;
    snprintf(path, sizeof(path), "%s/depth/depth_%04d.png", dir, i);
    if (d2r_png_decode_file(path, depth_raw.data(), long(d_frame * 2)) != 0)
      return -2000 - i;
    const uint16_t* mm = reinterpret_cast<const uint16_t*>(depth_raw.data());
    float* dst = depth_out + size_t(i) * d_frame;
    for (size_t p = 0; p < d_frame; ++p) dst[p] = float(mm[p]) / 1000.0f;
  }
  return 0;
}

}  // extern "C"
