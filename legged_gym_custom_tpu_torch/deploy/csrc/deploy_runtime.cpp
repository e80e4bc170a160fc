// Native deploy inference runtime for the 50 Hz real-robot loop (copy of
// csrc/deploy_runtime.cpp, the JAX package's runtime, for the PyTorch port).
//
// The reference ships TorchScript modules executed by libtorch's C++ runtime
// on the Jetson (deploy/base/deploy_base.py:32-35).  This is its native
// equivalent: a dependency-free C++ core that evaluates the exported Go2
// policy bundle (policy MLP + adaptation CNN + estimator + scan encoder, all
// ELU) from a flat binary weight file, exposed through a C ABI consumed via
// ctypes (legged_gym_custom_tpu_torch/deploy/native.py).
//
// Weight file format (written by deploy/native.py:write_flat_bundle):
//   magic "LGCT" | u32 version | u32 n_arrays
//   per array: u32 name_len | name bytes | u32 ndim | u32 dims[] | f32 data[]
//
// Build: deploy/native.py:build_library runs g++ at first use and writes
// build/native/liblgc_deploy_<hash of source and flags>.so

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace {

struct Array {
  std::vector<uint32_t> dims;
  std::vector<float> data;
};

struct Bundle {
  std::map<std::string, Array> arrays;
  // cached layer lists per module, in forward order
  std::vector<const Array*> policy_w, policy_b;
  std::vector<const Array*> est_w, est_b;
  std::vector<const Array*> scan_w, scan_b;
  // adaptation: dense_in, conv1, conv2, dense_out
  const Array *ad_w0, *ad_b0, *ad_c1, *ad_cb1, *ad_c2, *ad_cb2, *ad_w1, *ad_b1;
  int num_proprio = 52;
  int history = 10;
};

inline float elu(float x) { return x > 0.f ? x : std::expm1(x); }

// y = x @ W + b with W stored (in, out); optional ELU
void dense(const float* x, const Array& W, const Array& b, float* y,
           bool act) {
  const uint32_t in = W.dims[0], out = W.dims[1];
  for (uint32_t o = 0; o < out; ++o) y[o] = b.data[o];
  for (uint32_t i = 0; i < in; ++i) {
    const float xi = x[i];
    const float* w = &W.data[i * out];
    for (uint32_t o = 0; o < out; ++o) y[o] += xi * w[o];
  }
  if (act)
    for (uint32_t o = 0; o < out; ++o) y[o] = elu(y[o]);
}

void mlp(const float* x, const std::vector<const Array*>& Ws,
         const std::vector<const Array*>& bs, float* out) {
  std::vector<float> buf_a, buf_b;
  const float* cur = x;
  for (size_t l = 0; l < Ws.size(); ++l) {
    const bool last = l + 1 == Ws.size();
    std::vector<float>& dst_buf = (l % 2 == 0) ? buf_a : buf_b;
    dst_buf.resize(Ws[l]->dims[1]);
    float* dst = last ? out : dst_buf.data();
    dense(cur, *Ws[l], *bs[l], dst, /*act=*/!last);
    cur = dst;
  }
}

// VALID 1-D conv over (T, Cin) with flax kernel (k, Cin, Cout) + ELU
void conv1d(const std::vector<float>& x, int T, int Cin, const Array& K,
            const Array& b, std::vector<float>& y, int stride, int* T_out) {
  const int k = K.dims[0], Cout = K.dims[2];
  const int To = (T - k) / stride + 1;
  y.assign(To * Cout, 0.f);
  for (int t = 0; t < To; ++t) {
    float* yo = &y[t * Cout];
    for (int c = 0; c < Cout; ++c) yo[c] = b.data[c];
    for (int j = 0; j < k; ++j) {
      const float* xi = &x[(t * stride + j) * Cin];
      const float* kj = &K.data[j * Cin * Cout];
      for (int i = 0; i < Cin; ++i) {
        const float v = xi[i];
        const float* kr = &kj[i * Cout];
        for (int c = 0; c < Cout; ++c) yo[c] += v * kr[c];
      }
    }
    for (int c = 0; c < Cout; ++c) yo[c] = elu(yo[c]);
  }
  *T_out = To;
}

bool load_bundle(const char* path, Bundle* bd) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  char magic[4];
  uint32_t version, n;
  if (std::fread(magic, 1, 4, f) != 4 || std::memcmp(magic, "LGCT", 4) != 0 ||
      std::fread(&version, 4, 1, f) != 1 || std::fread(&n, 4, 1, f) != 1) {
    std::fclose(f);
    return false;
  }
  for (uint32_t a = 0; a < n; ++a) {
    uint32_t name_len, ndim;
    if (std::fread(&name_len, 4, 1, f) != 1) break;
    std::string name(name_len, '\0');
    if (std::fread(&name[0], 1, name_len, f) != name_len) break;
    if (std::fread(&ndim, 4, 1, f) != 1) break;
    Array arr;
    arr.dims.resize(ndim);
    uint64_t total = 1;
    for (uint32_t d = 0; d < ndim; ++d) {
      if (std::fread(&arr.dims[d], 4, 1, f) != 1) break;
      total *= arr.dims[d];
    }
    arr.data.resize(total);
    if (std::fread(arr.data.data(), 4, total, f) != total) break;
    bd->arrays.emplace(std::move(name), std::move(arr));
  }
  std::fclose(f);

  auto collect = [&](const char* mod, std::vector<const Array*>& Ws,
                     std::vector<const Array*>& bs) {
    for (int i = 0;; ++i) {
      char kk[96], kb[96];
      std::snprintf(kk, sizeof kk, "%s/%d/kernel", mod, i);
      std::snprintf(kb, sizeof kb, "%s/%d/bias", mod, i);
      auto it = bd->arrays.find(kk);
      if (it == bd->arrays.end()) break;
      Ws.push_back(&it->second);
      bs.push_back(&bd->arrays.at(kb));
    }
  };
  collect("policy", bd->policy_w, bd->policy_b);
  collect("estimator", bd->est_w, bd->est_b);
  collect("scan_encoder", bd->scan_w, bd->scan_b);

  // adaptation module: classify the 4 layers by kind/shape regardless of
  // index order (flax export and torch import order them differently —
  // mirrors NumpyAdaptationEncoder in deploy/controller.py)
  bd->ad_w0 = bd->ad_b0 = bd->ad_c1 = bd->ad_cb1 = nullptr;
  bd->ad_c2 = bd->ad_cb2 = bd->ad_w1 = bd->ad_b1 = nullptr;
  for (int i = 0; i < 8; ++i) {
    char kk[96], kc[96], kb[96];
    std::snprintf(kk, sizeof kk, "adaptation_module/%d/kernel", i);
    std::snprintf(kc, sizeof kc, "adaptation_module/%d/convkernel", i);
    std::snprintf(kb, sizeof kb, "adaptation_module/%d/bias", i);
    auto itb = bd->arrays.find(kb);
    if (itb == bd->arrays.end()) continue;
    auto itk = bd->arrays.find(kk);
    auto itc = bd->arrays.find(kc);
    if (itk != bd->arrays.end()) {
      // dense: larger input dim = the per-step encoder (num_proprio wide)
      if (!bd->ad_w0 || itk->second.dims[0] > bd->ad_w0->dims[0]) {
        if (bd->ad_w0) { bd->ad_w1 = bd->ad_w0; bd->ad_b1 = bd->ad_b0; }
        bd->ad_w0 = &itk->second;
        bd->ad_b0 = &itb->second;
      } else {
        bd->ad_w1 = &itk->second;
        bd->ad_b1 = &itb->second;
      }
    } else if (itc != bd->arrays.end()) {
      // conv: wider kernel first
      if (!bd->ad_c1 || itc->second.dims[0] > bd->ad_c1->dims[0]) {
        if (bd->ad_c1) { bd->ad_c2 = bd->ad_c1; bd->ad_cb2 = bd->ad_cb1; }
        bd->ad_c1 = &itc->second;
        bd->ad_cb1 = &itb->second;
      } else {
        bd->ad_c2 = &itc->second;
        bd->ad_cb2 = &itb->second;
      }
    }
  }
  if (!bd->ad_w0 || !bd->ad_w1 || !bd->ad_c1 || !bd->ad_c2) return false;
  bd->num_proprio = (int)bd->ad_w0->dims[0];
  return !bd->policy_w.empty() && !bd->est_w.empty() && !bd->scan_w.empty();
}

}  // namespace

extern "C" {

void* lgc_bundle_load(const char* path) {
  Bundle* bd = new Bundle();
  if (!load_bundle(path, bd)) {
    delete bd;
    return nullptr;
  }
  return bd;
}

void lgc_bundle_free(void* h) { delete static_cast<Bundle*>(h); }

int lgc_num_proprio(void* h) { return static_cast<Bundle*>(h)->num_proprio; }

// Full inference step: obs (history*P + P), scan -> actions.
// Mirrors deploy_base.py:244-270: adaptation(history) + estimator(obs) +
// scan_encoder(scan), concat into the policy.
int lgc_policy_forward(void* h, const float* obs, int obs_len,
                       const float* scan, int scan_len, float* actions,
                       int actions_len) {
  Bundle* bd = static_cast<Bundle*>(h);
  const int P = bd->num_proprio;
  const int H = obs_len / P - 1;

  // adaptation encoder over the history block
  const int c3 = (int)bd->ad_w0->dims[1];  // 30
  std::vector<float> proj(H * c3);
  for (int t = 0; t < H; ++t)
    dense(&obs[t * P], *bd->ad_w0, *bd->ad_b0, &proj[t * c3], true);
  std::vector<float> h1, h2;
  int T1, T2;
  conv1d(proj, H, c3, *bd->ad_c1, *bd->ad_cb1, h1, 2, &T1);
  conv1d(h1, T1, (int)bd->ad_c1->dims[2], *bd->ad_c2, *bd->ad_cb2, h2, 1, &T2);
  // channel-major flatten (torch parity; controller.py NumpyAdaptationEncoder)
  const int C2 = (int)bd->ad_c2->dims[2];
  std::vector<float> flat(T2 * C2);
  for (int c = 0; c < C2; ++c)
    for (int t = 0; t < T2; ++t) flat[c * T2 + t] = h2[t * C2 + c];
  std::vector<float> latent(bd->ad_w1->dims[1]);
  dense(flat.data(), *bd->ad_w1, *bd->ad_b1, latent.data(), true);

  // estimator + scan encoder
  std::vector<float> est(bd->est_w.back()->dims[1]);
  mlp(obs, bd->est_w, bd->est_b, est.data());
  std::vector<float> scan_lat(bd->scan_w.back()->dims[1]);
  mlp(scan, bd->scan_w, bd->scan_b, scan_lat.data());

  // actor input = [obs | latent | scan_latent | estimated]
  std::vector<float> actor_in;
  actor_in.reserve(obs_len + latent.size() + scan_lat.size() + est.size());
  actor_in.insert(actor_in.end(), obs, obs + obs_len);
  actor_in.insert(actor_in.end(), latent.begin(), latent.end());
  actor_in.insert(actor_in.end(), scan_lat.begin(), scan_lat.end());
  actor_in.insert(actor_in.end(), est.begin(), est.end());
  if ((int)bd->policy_w[0]->dims[0] != (int)actor_in.size()) return -1;
  if ((int)bd->policy_w.back()->dims[1] != actions_len) return -2;
  mlp(actor_in.data(), bd->policy_w, bd->policy_b, actions);
  return 0;
}

}  // extern "C"
