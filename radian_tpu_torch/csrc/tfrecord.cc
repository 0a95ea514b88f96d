// Native TFRecord reader/writer + tf.train.Example codec for the training
// data pipeline.
//
// The reference feeds training through the tf.data C++ runtime over
// TFRecord shards (reference radian/data.py:9-76).  This library provides
// the equivalent native substrate without a TensorFlow dependency: record
// framing (length / masked-crc32c / payload / masked-crc32c) and a
// protobuf codec specialised to the reference schema
// (reference data.py:10-15):
//
//   signal        float_list  (window_size values)
//   label         float_list  (variable length)
//   signal_length int64_list  (1 value)
//   label_length  int64_list  (1 value)
//
// Exposed via a C ABI consumed from Python with ctypes
// (radian_tpu_torch/io/tfrecord.py, built by radian_tpu_torch/_build.py),
// which also carries the pure-Python codec the tests hold it against.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// crc32c (Castagnoli), table-driven, with TFRecord masking.
// ---------------------------------------------------------------------------

uint32_t kCrcTable[256];
bool crc_init_done = false;

void InitCrcTable() {
  if (crc_init_done) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) {
      c = (c & 1) ? (0x82f63b78u ^ (c >> 1)) : (c >> 1);
    }
    kCrcTable[i] = c;
  }
  crc_init_done = true;
}

uint32_t Crc32c(const uint8_t* data, size_t n) {
  InitCrcTable();
  uint32_t c = 0xffffffffu;
  for (size_t i = 0; i < n; i++) {
    c = kCrcTable[(c ^ data[i]) & 0xff] ^ (c >> 8);
  }
  return c ^ 0xffffffffu;
}

uint32_t MaskedCrc(const uint8_t* data, size_t n) {
  uint32_t crc = Crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xa282ead8u;
}

// ---------------------------------------------------------------------------
// Minimal protobuf wire helpers.
// ---------------------------------------------------------------------------

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint64_t ReadVarint() {
    uint64_t v = 0;
    int shift = 0;
    while (p < end) {
      uint8_t b = *p++;
      v |= uint64_t(b & 0x7f) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
      if (shift > 63) break;
    }
    ok = false;
    return 0;
  }
};

void WriteVarint(std::string* out, uint64_t v) {
  while (v >= 0x80) {
    out->push_back(char((v & 0x7f) | 0x80));
    v >>= 7;
  }
  out->push_back(char(v));
}

void WriteTag(std::string* out, uint32_t field, uint32_t wire) {
  WriteVarint(out, (field << 3) | wire);
}

// ---------------------------------------------------------------------------
// Example parsing specialised to the radian schema.
// ---------------------------------------------------------------------------

struct ParsedExample {
  std::vector<float> signal;
  std::vector<float> label;
  int64_t signal_length = -1;
  int64_t label_length = -1;
};

bool ParseFloatList(Cursor c, std::vector<float>* out) {
  // Feature { float_list = 2 { repeated float value = 1 } }
  while (c.p < c.end && c.ok) {
    uint64_t tag = c.ReadVarint();
    uint32_t field = tag >> 3, wire = tag & 7;
    if (field == 1 && wire == 2) {  // packed
      uint64_t len = c.ReadVarint();
      if (c.p + len > c.end || len % 4) return false;
      size_t n = len / 4;
      size_t base = out->size();
      out->resize(base + n);
      memcpy(out->data() + base, c.p, len);
      c.p += len;
    } else if (field == 1 && wire == 5) {  // unpacked float
      if (c.p + 4 > c.end) return false;
      float f;
      memcpy(&f, c.p, 4);
      out->push_back(f);
      c.p += 4;
    } else {
      return false;
    }
  }
  return c.ok;
}

bool ParseInt64List(Cursor c, int64_t* out) {
  while (c.p < c.end && c.ok) {
    uint64_t tag = c.ReadVarint();
    uint32_t field = tag >> 3, wire = tag & 7;
    if (field == 1 && wire == 2) {  // packed
      uint64_t len = c.ReadVarint();
      const uint8_t* stop = c.p + len;
      if (stop > c.end) return false;
      while (c.p < stop && c.ok) *out = int64_t(c.ReadVarint());
    } else if (field == 1 && wire == 0) {
      *out = int64_t(c.ReadVarint());
    } else {
      return false;
    }
  }
  return c.ok;
}

// Parse one serialized tf.train.Example.
bool ParseExample(const uint8_t* data, size_t n, ParsedExample* ex) {
  Cursor c{data, data + n};
  // Example { Features features = 1 }
  while (c.p < c.end && c.ok) {
    uint64_t tag = c.ReadVarint();
    if ((tag >> 3) != 1 || (tag & 7) != 2) return false;
    uint64_t len = c.ReadVarint();
    const uint8_t* fend = c.p + len;
    if (fend > c.end) return false;
    Cursor fc{c.p, fend};
    // Features { map<string, Feature> feature = 1 } — map entries
    while (fc.p < fc.end && fc.ok) {
      uint64_t etag = fc.ReadVarint();
      if ((etag >> 3) != 1 || (etag & 7) != 2) return false;
      uint64_t elen = fc.ReadVarint();
      const uint8_t* eend = fc.p + elen;
      if (eend > fc.end) return false;
      Cursor ec{fc.p, eend};
      std::string key;
      const uint8_t* val = nullptr;
      size_t val_len = 0;
      while (ec.p < ec.end && ec.ok) {
        uint64_t ktag = ec.ReadVarint();
        uint32_t kf = ktag >> 3, kw = ktag & 7;
        uint64_t klen = ec.ReadVarint();
        if (ec.p + klen > ec.end) return false;
        if (kf == 1 && kw == 2) {
          key.assign(reinterpret_cast<const char*>(ec.p), klen);
        } else if (kf == 2 && kw == 2) {
          val = ec.p;
          val_len = klen;
        }
        ec.p += klen;
      }
      if (val) {
        // Feature: skip the oneof wrapper tag to its payload
        Cursor vc{val, val + val_len};
        uint64_t vtag = vc.ReadVarint();
        uint32_t vf = vtag >> 3;
        uint64_t vlen = vc.ReadVarint();
        if (vc.p + vlen > vc.end) return false;
        Cursor payload{vc.p, vc.p + vlen};
        if (key == "signal" && vf == 2) {
          if (!ParseFloatList(payload, &ex->signal)) return false;
        } else if (key == "label" && vf == 2) {
          if (!ParseFloatList(payload, &ex->label)) return false;
        } else if (key == "signal_length" && vf == 3) {
          if (!ParseInt64List(payload, &ex->signal_length)) return false;
        } else if (key == "label_length" && vf == 3) {
          if (!ParseInt64List(payload, &ex->label_length)) return false;
        }
      }
      fc.p = eend;
    }
    c.p = fend;
  }
  return c.ok;
}

}  // namespace

extern "C" {

// Parse a whole TFRecord shard into flat buffers.
//
// Returns the number of examples, or -1 on framing/parse error.  Caller
// provides capacities; the function writes up to the capacity and reports
// the true totals so the caller can size a second pass.
//
//  signals:    [cap_examples * window]   float32 (zero-padded rows)
//  labels:     [cap_examples * max_label] float32 (zero-padded)
//  sig_lens:   [cap_examples] int64
//  lab_lens:   [cap_examples] int64
long ParseShard(const uint8_t* buf, long buf_len, long window, long max_label,
                long cap_examples, float* signals, float* labels,
                long long* sig_lens, long long* lab_lens, int verify_crc) {
  const uint8_t* p = buf;
  const uint8_t* end = buf + buf_len;
  long n = 0;
  while (p < end) {
    if (p + 12 > end) return -1;
    uint64_t len;
    memcpy(&len, p, 8);
    uint32_t len_crc;
    memcpy(&len_crc, p + 8, 4);
    if (verify_crc && MaskedCrc(p, 8) != len_crc) return -1;
    p += 12;
    if (p + len + 4 > end) return -1;
    const uint8_t* payload = p;
    p += len;
    uint32_t data_crc;
    memcpy(&data_crc, p, 4);
    if (verify_crc && MaskedCrc(payload, len) != data_crc) return -1;
    p += 4;

    if (n < cap_examples) {
      ParsedExample ex;
      if (!ParseExample(payload, len, &ex)) return -1;
      float* srow = signals + n * window;
      long scopy = long(ex.signal.size()) < window ? long(ex.signal.size())
                                                   : window;
      memset(srow, 0, sizeof(float) * window);
      memcpy(srow, ex.signal.data(), sizeof(float) * scopy);
      float* lrow = labels + n * max_label;
      long lcopy = long(ex.label.size()) < max_label ? long(ex.label.size())
                                                     : max_label;
      memset(lrow, 0, sizeof(float) * max_label);
      memcpy(lrow, ex.label.data(), sizeof(float) * lcopy);
      sig_lens[n] = ex.signal_length >= 0 ? ex.signal_length
                                          : int64_t(ex.signal.size());
      lab_lens[n] = ex.label_length >= 0 ? ex.label_length
                                         : int64_t(ex.label.size());
    }
    n++;
  }
  return n;
}

// Serialize one example into the TFRecord framing; returns bytes written
// or -1 if out_cap is too small.
long WriteExample(const float* signal, long signal_n, const float* label,
                  long label_n, long long signal_length, long long label_length,
                  uint8_t* out, long out_cap) {
  std::string feat;

  auto add_float_feature = [&](const char* key, const float* v, long n) {
    std::string flist;
    WriteTag(&flist, 1, 2);
    WriteVarint(&flist, uint64_t(n) * 4);
    flist.append(reinterpret_cast<const char*>(v), n * 4);
    std::string feature;
    WriteTag(&feature, 2, 2);  // float_list
    WriteVarint(&feature, flist.size());
    feature += flist;
    std::string entry;
    WriteTag(&entry, 1, 2);
    WriteVarint(&entry, strlen(key));
    entry += key;
    WriteTag(&entry, 2, 2);
    WriteVarint(&entry, feature.size());
    entry += feature;
    WriteTag(&feat, 1, 2);
    WriteVarint(&feat, entry.size());
    feat += entry;
  };

  auto add_int_feature = [&](const char* key, long long v) {
    std::string ilist;
    WriteTag(&ilist, 1, 0);
    WriteVarint(&ilist, uint64_t(v));
    std::string feature;
    WriteTag(&feature, 3, 2);  // int64_list
    WriteVarint(&feature, ilist.size());
    feature += ilist;
    std::string entry;
    WriteTag(&entry, 1, 2);
    WriteVarint(&entry, strlen(key));
    entry += key;
    WriteTag(&entry, 2, 2);
    WriteVarint(&entry, feature.size());
    entry += feature;
    WriteTag(&feat, 1, 2);
    WriteVarint(&feat, entry.size());
    feat += entry;
  };

  add_float_feature("signal", signal, signal_n);
  add_float_feature("label", label, label_n);
  add_int_feature("signal_length", signal_length);
  add_int_feature("label_length", label_length);

  std::string example;
  WriteTag(&example, 1, 2);
  WriteVarint(&example, feat.size());
  example += feat;

  uint64_t len = example.size();
  long total = long(12 + len + 4);
  if (total > out_cap) return -1;
  memcpy(out, &len, 8);
  uint32_t len_crc = MaskedCrc(out, 8);
  memcpy(out + 8, &len_crc, 4);
  memcpy(out + 12, example.data(), len);
  uint32_t data_crc =
      MaskedCrc(reinterpret_cast<const uint8_t*>(example.data()), len);
  memcpy(out + 12 + len, &data_crc, 4);
  return total;
}

uint32_t MaskedCrc32c(const uint8_t* data, long n) {
  return MaskedCrc(data, size_t(n));
}

}  // extern "C"
