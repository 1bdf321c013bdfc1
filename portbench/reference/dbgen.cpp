// Native TPC-H generator core.
//
// Role parity: velox/tpch/gen/ (vendored dbgen C producing columnar
// batches; TpchGen.h:38-120). This is the C++ twin of the numpy generator
// in velox_tpu/connectors/tpch.py: the SAME counter-based splitmix64
// streams, bit-for-bit, so python and native outputs are interchangeable
// (tests assert equality). Exposed via a C ABI and loaded with ctypes.
//
// Build: velox_tpu/native/build.py (g++ -O3 -shared, cached by source hash).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t kMix1 = 0xBF58476D1CE4E5B9ULL;
constexpr uint64_t kMix2 = 0x94D049BB133111EBULL;
constexpr uint64_t kGolden = 0x9E3779B97F4A7C15ULL;

inline uint64_t mix64(uint64_t x) {
  x = (x ^ (x >> 30)) * kMix1;
  x = (x ^ (x >> 27)) * kMix2;
  return x ^ (x >> 31);
}

inline uint64_t rng(uint64_t stream, uint64_t idx) {
  return mix64(idx + stream * kGolden);
}

inline int64_t uniform_int(uint64_t stream, uint64_t idx, int64_t lo,
                           int64_t hi) {
  uint64_t span = static_cast<uint64_t>(hi - lo + 1);
  return lo + static_cast<int64_t>(rng(stream, idx) % span);
}

// Stream ids — MUST match velox_tpu/connectors/tpch.py `_S`.
enum Stream : uint64_t {
  kLQuantity = 1, kLDiscount = 2, kLTax = 3, kLPartkey = 4, kLSuppkey = 5,
  kLShipdate = 6, kLCommit = 7, kLReceipt = 8, kLShipmode = 9,
  kLShipinstruct = 10, kLComment = 11, kLReturnflag = 12,
  kOCustkey = 64, kODate = 65, kOPriority = 66, kOClerk = 67,
  kOComment = 69, kOLinecount = 70,
};

constexpr int64_t kEpoch1992 = 8035;
constexpr int64_t kOrderDateSpan = 10591 - 8035 - 151;
constexpr int64_t kCurrentDate = 9298;  // 1995-06-17

inline int64_t order_key(int64_t idx) {
  return ((idx >> 3) << 5) | (idx & 7);
}

inline int64_t line_count(int64_t order_idx) {
  return uniform_int(kOLinecount, order_idx, 1, 7);
}

inline int64_t part_price_cents(int64_t p) {
  return 90000 + ((p / 10) % 20001) + 100 * (p % 1000);
}

inline int32_t order_date(int64_t order_idx) {
  return static_cast<int32_t>(
      kEpoch1992 + uniform_int(kODate, order_idx, 0, kOrderDateSpan));
}

struct LineVals {
  int64_t quantity_raw, partkey, suppkey, extprice, discount, tax;
  int32_t shipdate, commitdate, receiptdate;
};

inline LineVals gen_line(int64_t gid, int64_t odate, int64_t nparts,
                         int64_t nsupp) {
  LineVals v;
  v.quantity_raw = uniform_int(kLQuantity, gid, 1, 50);
  v.partkey = uniform_int(kLPartkey, gid, 1, nparts);
  int64_t i4 = gid % 4;
  v.suppkey =
      (v.partkey + i4 * (nsupp / 4 + v.partkey / nsupp)) % nsupp + 1;
  v.extprice = part_price_cents(v.partkey) * v.quantity_raw;
  v.discount = uniform_int(kLDiscount, gid, 0, 10);
  v.tax = uniform_int(kLTax, gid, 0, 8);
  v.shipdate =
      static_cast<int32_t>(odate + uniform_int(kLShipdate, gid, 1, 121));
  v.commitdate =
      static_cast<int32_t>(odate + uniform_int(kLCommit, gid, 30, 90));
  v.receiptdate = static_cast<int32_t>(v.shipdate +
                                       uniform_int(kLReceipt, gid, 1, 30));
  return v;
}

}  // namespace

namespace {

// The counter-based streams make every order independent: threads carve
// the order range and each computes its own output offset from the
// prefix line counts (deterministic regardless of thread count).
int64_t lineitem_rows_range(int64_t lo, int64_t hi) {
  int64_t total = 0;
  for (int64_t i = lo; i < hi; ++i) total += line_count(i);
  return total;
}

void run_parallel(int64_t lo, int64_t hi, int64_t nthreads,
                  void (*body)(int64_t, int64_t, int64_t, void*),
                  void* ctx) {
  int64_t n = hi - lo;
  int64_t hw = static_cast<int64_t>(std::thread::hardware_concurrency());
  if (nthreads <= 0) nthreads = hw > 0 ? hw : 1;
  if (nthreads > n) nthreads = n > 0 ? n : 1;
  if (nthreads <= 1) {
    body(lo, hi, 0, ctx);
    return;
  }
  std::vector<std::thread> ts;
  ts.reserve(nthreads);
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    int64_t clo = lo + t * chunk;
    int64_t chi = clo + chunk < hi ? clo + chunk : hi;
    if (clo >= chi) break;
    ts.emplace_back(body, clo, chi, t, ctx);
  }
  for (auto& th : ts) th.join();
}

struct LineArgs {
  int64_t lo, nparts, nsupp, n_words_sq;
  int64_t *orderkey, *partkey, *suppkey, *quantity, *extendedprice,
      *discount, *tax;
  int32_t *linenumber, *returnflag, *linestatus, *shipdate, *commitdate,
      *receiptdate, *shipinstruct, *shipmode, *comment;
};

void gen_lineitem_range(int64_t lo, int64_t hi, int64_t /*tid*/,
                        void* vctx) {
  const LineArgs& a = *static_cast<LineArgs*>(vctx);
  int64_t nparts = a.nparts, nsupp = a.nsupp, n_words_sq = a.n_words_sq;
  int64_t* orderkey = a.orderkey;
  int64_t* partkey = a.partkey;
  int64_t* suppkey = a.suppkey;
  int32_t* linenumber = a.linenumber;
  int64_t* quantity = a.quantity;
  int64_t* extendedprice = a.extendedprice;
  int64_t* discount = a.discount;
  int64_t* tax = a.tax;
  int32_t* returnflag = a.returnflag;
  int32_t* linestatus = a.linestatus;
  int32_t* shipdate = a.shipdate;
  int32_t* commitdate = a.commitdate;
  int32_t* receiptdate = a.receiptdate;
  int32_t* shipinstruct = a.shipinstruct;
  int32_t* shipmode = a.shipmode;
  int32_t* comment = a.comment;
  int64_t r = lineitem_rows_range(a.lo, lo);
  for (int64_t oi = lo; oi < hi; ++oi) {
    int64_t cnt = line_count(oi);
    int64_t odate = order_date(oi);
    int64_t okey = order_key(oi);
    for (int64_t ln = 0; ln < cnt; ++ln, ++r) {
      int64_t gid = oi * 8 + ln;
      LineVals v = gen_line(gid, odate, nparts, nsupp);
      if (orderkey) orderkey[r] = okey;
      if (partkey) partkey[r] = v.partkey;
      if (suppkey) suppkey[r] = v.suppkey;
      if (linenumber) linenumber[r] = static_cast<int32_t>(ln + 1);
      if (quantity) quantity[r] = v.quantity_raw * 100;
      if (extendedprice) extendedprice[r] = v.extprice;
      if (discount) discount[r] = v.discount;
      if (tax) tax[r] = v.tax;
      if (returnflag) {
        int64_t rr = uniform_int(kLReturnflag, gid, 0, 1);
        returnflag[r] = (v.receiptdate <= kCurrentDate)
                            ? (rr == 0 ? 0 : 2)
                            : 1;  // A=0, N=1, R=2
      }
      if (linestatus) linestatus[r] = v.shipdate > kCurrentDate ? 1 : 0;
      if (shipdate) shipdate[r] = v.shipdate;
      if (commitdate) commitdate[r] = v.commitdate;
      if (receiptdate) receiptdate[r] = v.receiptdate;
      if (shipinstruct)
        shipinstruct[r] =
            static_cast<int32_t>(uniform_int(kLShipinstruct, gid, 0, 3));
      if (shipmode)
        shipmode[r] =
            static_cast<int32_t>(uniform_int(kLShipmode, gid, 0, 6));
      if (comment)
        comment[r] = static_cast<int32_t>(
            uniform_int(kLComment, gid, 0, n_words_sq - 1));
    }
  }
}

struct OrderArgs {
  int64_t nparts, nsupp, ncust_allowed, nclerk, n_words_sq, lo;
  int64_t *orderkey, *custkey, *totalprice;
  int32_t *orderstatus, *orderdate, *orderpriority, *clerk, *shippriority,
      *comment;
};

void gen_orders_range(int64_t lo, int64_t hi, int64_t /*tid*/, void* vctx);

}  // namespace

extern "C" {

// Total lineitem rows for orders [lo, hi).
int64_t tpch_lineitem_rows(int64_t lo, int64_t hi) {
  return lineitem_rows_range(lo, hi);
}

// Fill lineitem columns for orders [lo, hi) across nthreads threads
// (0 = hardware concurrency). Null pointers are skipped. Caller sizes
// buffers with tpch_lineitem_rows. Money columns are DECIMAL(12,2)
// scaled ints; string columns are dictionary ids.
void tpch_gen_lineitem(
    int64_t lo, int64_t hi, int64_t nparts, int64_t nsupp,
    int64_t* orderkey, int64_t* partkey, int64_t* suppkey,
    int32_t* linenumber, int64_t* quantity, int64_t* extendedprice,
    int64_t* discount, int64_t* tax, int32_t* returnflag,
    int32_t* linestatus, int32_t* shipdate, int32_t* commitdate,
    int32_t* receiptdate, int32_t* shipinstruct, int32_t* shipmode,
    int32_t* comment, int64_t n_words_sq, int64_t nthreads) {
  LineArgs a{lo, nparts, nsupp, n_words_sq,
             orderkey, partkey, suppkey, quantity, extendedprice,
             discount, tax,
             linenumber, returnflag, linestatus, shipdate, commitdate,
             receiptdate, shipinstruct, shipmode, comment};
  run_parallel(lo, hi, nthreads, gen_lineitem_range, &a);
}

// Fill orders columns for order indices [lo, hi) across nthreads
// threads (0 = hardware concurrency). Null pointers skipped.
void tpch_gen_orders(
    int64_t lo, int64_t hi, int64_t nparts, int64_t nsupp,
    int64_t ncust_allowed, int64_t nclerk,
    int64_t* orderkey, int64_t* custkey, int32_t* orderstatus,
    int64_t* totalprice, int32_t* orderdate, int32_t* orderpriority,
    int32_t* clerk, int32_t* shippriority, int32_t* comment,
    int64_t n_words_sq, int64_t nthreads) {
  OrderArgs a{nparts, nsupp, ncust_allowed, nclerk, n_words_sq, lo,
              orderkey, custkey, totalprice,
              orderstatus, orderdate, orderpriority, clerk, shippriority,
              comment};
  run_parallel(lo, hi, nthreads, gen_orders_range, &a);
}

}  // extern "C"

namespace {

void gen_orders_range(int64_t lo, int64_t hi, int64_t /*tid*/,
                      void* vctx) {
  const OrderArgs& a = *static_cast<OrderArgs*>(vctx);
  int64_t nparts = a.nparts, nsupp = a.nsupp;
  int64_t ncust_allowed = a.ncust_allowed, nclerk = a.nclerk;
  int64_t n_words_sq = a.n_words_sq;
  int64_t* orderkey = a.orderkey;
  int64_t* custkey = a.custkey;
  int32_t* orderstatus = a.orderstatus;
  int64_t* totalprice = a.totalprice;
  int32_t* orderdate = a.orderdate;
  int32_t* orderpriority = a.orderpriority;
  int32_t* clerk = a.clerk;
  int32_t* shippriority = a.shippriority;
  int32_t* comment = a.comment;
  for (int64_t oi = lo; oi < hi; ++oi) {
    int64_t r = oi - a.lo;
    if (orderkey) orderkey[r] = order_key(oi);
    if (custkey) {
      int64_t k = uniform_int(kOCustkey, oi, 0, ncust_allowed - 1);
      custkey[r] = 3 * (k / 2) + 1 + (k % 2);
    }
    if (orderdate) orderdate[r] = order_date(oi);
    if (orderpriority)
      orderpriority[r] =
          static_cast<int32_t>(uniform_int(kOPriority, oi, 0, 4));
    if (clerk)
      clerk[r] = static_cast<int32_t>(uniform_int(kOClerk, oi, 1, nclerk));
    if (shippriority) shippriority[r] = 0;
    if (comment)
      comment[r] = static_cast<int32_t>(
          uniform_int(kOComment, oi, 0, n_words_sq - 1));
    if (orderstatus || totalprice) {
      int64_t cnt = line_count(oi);
      int64_t odate = order_date(oi);
      int64_t total = 0;
      bool all_f = true, all_o = true;
      for (int64_t ln = 0; ln < cnt; ++ln) {
        LineVals v = gen_line(oi * 8 + ln, odate, nparts, nsupp);
        total += v.extprice * (100 - v.discount) * (100 + v.tax);
        bool shipped = v.shipdate <= kCurrentDate;
        all_f &= shipped;
        all_o &= !shipped;
      }
      if (totalprice) totalprice[r] = (total + 5000) / 10000;
      if (orderstatus) orderstatus[r] = all_f ? 0 : (all_o ? 1 : 2);
    }
  }
}

}  // namespace
