// Native data-loading core: atomic .inter parsing, iterative k-core
// filtering, ID remapping, leave-one-out splitting, and prefix
// augmentation — the host-side data pipeline the Python layer
// (datamining_recblr_tpu/data/dataset.py) implements in pandas/NumPy,
// reimplemented in C++ for large datasets (Yelp/H&M scale), exposed
// through a C ABI consumed via ctypes (data/native.py).
//
// The output contract is bit-identical to the Python builder: same
// first-appearance ID order over the time-sorted table, same stable
// sort, same per-user split and sample ordering — tests assert array
// equality between the two paths.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include <cstdio>

namespace {

struct Row {
  int32_t user;   // token index into user_tokens_raw
  int32_t item;   // token index into item_tokens_raw
  double time;
  int64_t order;  // original file order, for stable sorting
};

struct Sample {
  int32_t user;
  int64_t begin;  // range into item stream of this user's list
  int64_t end;    // prefix end (exclusive)
  int32_t target;
};

struct Dataset {
  int64_t n_users = 0, n_items = 0, n_inter = 0;
  int32_t max_len = 0;
  std::vector<std::string> user_tokens;  // [1..n_users), id order
  std::vector<std::string> item_tokens;
  std::vector<int32_t> stream;           // concatenated per-user item lists
  std::vector<int64_t> user_offsets;     // n_users+1 offsets into stream
  std::vector<int64_t> train_offsets;    // per-user train-part length
  std::vector<Sample> train, valid, test;
};

bool parse_line(const char* p, const char* end, int ucol, int icol, int tcol,
                std::string* u, std::string* it, double* t) {
  int col = 0;
  const char* field = p;
  int maxcol = std::max(ucol, std::max(icol, tcol));
  while (true) {
    const char* tab = field;
    while (tab < end && *tab != '\t') tab++;
    if (col == ucol) u->assign(field, tab - field);
    if (col == icol) it->assign(field, tab - field);
    if (col == tcol) *t = strtod(std::string(field, tab - field).c_str(), nullptr);
    if (col >= maxcol) return true;
    if (tab >= end) return false;
    field = tab + 1;
    col++;
  }
}

}  // namespace

extern "C" {

// Builds the dataset; returns an opaque handle (or nullptr on error).
void* rb_build(const char* path, int32_t max_len, int ucol, int icol, int tcol,
               double u_lo, double u_hi, int u_lo_incl, int u_hi_incl,
               double i_lo, double i_hi, int i_lo_incl, int i_hi_incl) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(size, '\0');
  if (fread(buf.data(), 1, size, f) != (size_t)size) {
    fclose(f);
    return nullptr;
  }
  fclose(f);

  // raw token interning (file order)
  std::unordered_map<std::string, int32_t> user_ids, item_ids;
  std::vector<std::string> user_raw, item_raw;
  std::vector<Row> rows;
  rows.reserve(1 << 20);

  const char* p = buf.data();
  const char* end = p + buf.size();
  // skip header line
  while (p < end && *p != '\n') p++;
  if (p < end) p++;

  std::string u, it;
  int64_t order = 0;
  while (p < end) {
    const char* nl = p;
    while (nl < end && *nl != '\n') nl++;
    if (nl > p) {
      const char* line_end = (nl > p && nl[-1] == '\r') ? nl - 1 : nl;
      double t = 0;
      if (parse_line(p, line_end, ucol, icol, tcol, &u, &it, &t)) {
        auto ui = user_ids.emplace(u, (int32_t)user_raw.size());
        if (ui.second) user_raw.push_back(u);
        auto ii = item_ids.emplace(it, (int32_t)item_raw.size());
        if (ii.second) item_raw.push_back(it);
        rows.push_back({ui.first->second, ii.first->second, t, order++});
      }
    }
    p = nl + 1;
  }

  auto in_interval = [](double c, double lo, double hi, int lo_incl,
                        int hi_incl) {
    bool ok_lo = lo_incl ? (c >= lo) : (c > lo);
    bool ok_hi = hi_incl ? (c <= hi) : (c < hi);
    return ok_lo && ok_hi;
  };

  // iterative k-core: drop users outside interval, then items, repeat
  std::vector<uint8_t> alive(rows.size(), 1);
  std::vector<int64_t> ucnt(user_raw.size()), icnt(item_raw.size());
  size_t n_alive = rows.size();
  while (true) {
    size_t before = n_alive;
    std::fill(ucnt.begin(), ucnt.end(), 0);
    for (size_t r = 0; r < rows.size(); r++)
      if (alive[r]) ucnt[rows[r].user]++;
    for (size_t r = 0; r < rows.size(); r++)
      if (alive[r] &&
          !in_interval((double)ucnt[rows[r].user], u_lo, u_hi, u_lo_incl,
                       u_hi_incl)) {
        alive[r] = 0;
        n_alive--;
      }
    std::fill(icnt.begin(), icnt.end(), 0);
    for (size_t r = 0; r < rows.size(); r++)
      if (alive[r]) icnt[rows[r].item]++;
    for (size_t r = 0; r < rows.size(); r++)
      if (alive[r] &&
          !in_interval((double)icnt[rows[r].item], i_lo, i_hi, i_lo_incl,
                       i_hi_incl)) {
        alive[r] = 0;
        n_alive--;
      }
    if (n_alive == before) break;
  }

  // stable sort survivors by timestamp (ties keep file order)
  std::vector<const Row*> sorted;
  sorted.reserve(n_alive);
  for (size_t r = 0; r < rows.size(); r++)
    if (alive[r]) sorted.push_back(&rows[r]);
  std::stable_sort(sorted.begin(), sorted.end(),
                   [](const Row* a, const Row* b) { return a->time < b->time; });

  auto* ds = new Dataset();
  ds->max_len = max_len;
  ds->n_inter = (int64_t)sorted.size();

  // remap to contiguous ids (PAD=0) in first-appearance order over the
  // time-sorted table — identical to dataset.py::_remap
  std::vector<int32_t> user_map(user_raw.size(), -1),
      item_map(item_raw.size(), -1);
  ds->user_tokens.reserve(user_raw.size());
  ds->item_tokens.reserve(item_raw.size());
  std::vector<int32_t> su(sorted.size()), si(sorted.size());
  for (size_t k = 0; k < sorted.size(); k++) {
    const Row* r = sorted[k];
    if (user_map[r->user] < 0) {
      user_map[r->user] = (int32_t)ds->user_tokens.size() + 1;
      ds->user_tokens.push_back(user_raw[r->user]);
    }
    if (item_map[r->item] < 0) {
      item_map[r->item] = (int32_t)ds->item_tokens.size() + 1;
      ds->item_tokens.push_back(item_raw[r->item]);
    }
    su[k] = user_map[r->user];
    si[k] = item_map[r->item];
  }
  ds->n_users = (int64_t)ds->user_tokens.size() + 1;
  ds->n_items = (int64_t)ds->item_tokens.size() + 1;

  // group by user preserving time order (counting sort = stable)
  std::vector<int64_t> counts(ds->n_users, 0);
  for (auto uid : su) counts[uid]++;
  ds->user_offsets.assign(ds->n_users + 1, 0);
  for (int64_t uid = 1; uid < ds->n_users; uid++)
    ds->user_offsets[uid + 1] = ds->user_offsets[uid] + counts[uid];
  std::vector<int64_t> cursor(ds->user_offsets.begin(),
                              ds->user_offsets.end() - 1);
  ds->stream.resize(sorted.size());
  for (size_t k = 0; k < sorted.size(); k++) ds->stream[cursor[su[k]]++] = si[k];

  // leave-one-out split + prefix augmentation (same ordering as the
  // Python builder: users in id order)
  ds->train_offsets.assign(ds->n_users, 0);
  for (int32_t uid = 1; uid < (int32_t)ds->n_users; uid++) {
    int64_t b = ds->user_offsets[uid], e = ds->user_offsets[uid + 1];
    int64_t len = e - b;
    if (len < 3) {
      ds->train_offsets[uid] = len;
      for (int64_t k = 1; k < len; k++)
        ds->train.push_back({uid, b, b + k, ds->stream[b + k]});
      continue;
    }
    int64_t train_len = len - 2;
    ds->train_offsets[uid] = train_len;
    for (int64_t k = 1; k < train_len; k++)
      ds->train.push_back({uid, b, b + k, ds->stream[b + k]});
    ds->valid.push_back({uid, b, b + train_len, ds->stream[b + len - 2]});
    ds->test.push_back({uid, b, b + len - 1, ds->stream[b + len - 1]});
  }
  return ds;
}

int64_t rb_stat(void* h, int which) {
  auto* ds = (Dataset*)h;
  switch (which) {
    case 0: return ds->n_users;
    case 1: return ds->n_items;
    case 2: return ds->n_inter;
    case 3: return (int64_t)ds->train.size();
    case 4: return (int64_t)ds->valid.size();
    case 5: return (int64_t)ds->test.size();
    default: return -1;
  }
}

// Fills caller-allocated arrays for split 0=train 1=valid 2=test.
void rb_fill_split(void* h, int split, int32_t* seq, int32_t* len,
                   int32_t* tgt, int32_t* usr) {
  auto* ds = (Dataset*)h;
  const std::vector<Sample>& s =
      split == 0 ? ds->train : (split == 1 ? ds->valid : ds->test);
  int32_t L = ds->max_len;
  for (size_t j = 0; j < s.size(); j++) {
    int64_t n = s[j].end - s[j].begin;
    int64_t start = s[j].begin + (n > L ? n - L : 0);
    int64_t w = s[j].end - start;
    int32_t* out = seq + (int64_t)j * L;
    std::memset(out, 0, sizeof(int32_t) * L);
    for (int64_t k = 0; k < w; k++) out[k] = ds->stream[start + k];
    len[j] = (int32_t)w;
    tgt[j] = s[j].target;
    usr[j] = s[j].user;
  }
}

// Byte size needed for the newline-joined token list (0=user, 1=item).
int64_t rb_tokens_size(void* h, int which) {
  auto* ds = (Dataset*)h;
  const auto& v = which == 0 ? ds->user_tokens : ds->item_tokens;
  int64_t total = 0;
  for (const auto& s : v) total += (int64_t)s.size() + 1;
  return total;
}

void rb_tokens(void* h, int which, char* buf) {
  auto* ds = (Dataset*)h;
  const auto& v = which == 0 ? ds->user_tokens : ds->item_tokens;
  char* p = buf;
  for (const auto& s : v) {
    std::memcpy(p, s.data(), s.size());
    p += s.size();
    *p++ = '\n';
  }
}

// Per-user train-list data for history masks: offsets [n_users+1] and
// the item stream slice boundaries.
void rb_train_lists(void* h, int64_t* offsets, int32_t* items) {
  auto* ds = (Dataset*)h;
  int64_t pos = 0;
  offsets[0] = 0;
  for (int64_t uid = 1; uid < ds->n_users; uid++) {
    int64_t b = ds->user_offsets[uid];
    int64_t tl = ds->train_offsets[uid];
    for (int64_t k = 0; k < tl; k++) items[pos++] = ds->stream[b + k];
    offsets[uid] = pos;
  }
}

int64_t rb_train_items_total(void* h) {
  auto* ds = (Dataset*)h;
  int64_t total = 0;
  for (int64_t uid = 1; uid < ds->n_users; uid++)
    total += ds->train_offsets[uid];
  return total;
}

void rb_free(void* h) { delete (Dataset*)h; }

}  // extern "C"
