// Native batch assembler for the training input pipeline.
//
// Gathers variable-length utterances (int32 token ids + float32 mel frames)
// out of memory-mapped record-shard blobs straight into preallocated padded
// batch tensors, in one call per batch with no per-utterance Python or NumPy
// dispatch. It is the counterpart of the reference's tf.data
// parse+padded_batch stage (reference datasets/tf_record_utils.py:108-142),
// which ran as TensorFlow C++ ops; exposed over a plain C ABI and loaded
// with ctypes.
//
// Unlike vaenar_tts_tpu/native/batchpack.cc, which the JAX loader calls once
// for each shard a batch draws from and which starts up to 8 threads a call,
// this copy takes every row of the batch at once, by source address, and
// copies on the caller's thread: the cost of a batch is the page faults of
// its freshly zeroed output, which threads only contend for.

// Build: vaenar_tts_torch/native/__init__.py runs, at first use,
//   g++ -O3 -march=native -shared -fPIC -std=c++17 -o libbatchpack.so
//       batchpack.cc

#include <cstdint>
#include <cstring>

extern "C" {

// Copy n utterances into rows 0..n-1 of the padded outputs.
//   src:       int64 [n, 4] of (text address, text length, mel address,
//              mel length): the addresses of an utterance's int32 tokens and
//              its float32 frames [length, num_mels] in a mapped shard
//   texts_out: [n, text_max] int32, pre-zeroed by the caller
//   mels_out:  [n, mel_max, num_mels] float32, pre-zeroed
// The caller guarantees text length <= text_max and mel length <= mel_max.
void pack_rows(const int64_t* src, int64_t n, int64_t num_mels,
               int32_t* texts_out, int64_t text_max, float* mels_out,
               int64_t mel_max, int32_t* tlens_out, int32_t* mlens_out) {
  const int64_t mel_row_elems = mel_max * num_mels;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t* s = src + 4 * i;
    const int64_t tl = s[1];
    const int64_t ml = s[3];
    std::memcpy(texts_out + i * text_max, reinterpret_cast<const int32_t*>(s[0]),
                sizeof(int32_t) * static_cast<size_t>(tl));
    std::memcpy(mels_out + i * mel_row_elems, reinterpret_cast<const float*>(s[2]),
                sizeof(float) * static_cast<size_t>(ml * num_mels));
    tlens_out[i] = static_cast<int32_t>(tl);
    mlens_out[i] = static_cast<int32_t>(ml);
  }
}

}  // extern "C"
