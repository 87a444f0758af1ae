// ThreadSanitizer driver for the OD4 endpoint (built by `make tsan`,
// run by tests/test_native_tsan.py). Hammers the concurrent surface:
// receive thread vs send/wait/drain/stats from worker threads vs close
// racing in-flight calls. Exits 0 iff the scenario completes; TSan itself
// reports races on stderr and (with exitcode set) fails the process.
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {
int64_t od4r_open(uint32_t cid, uint16_t port, int rcvbuf, const char* iface);
int64_t od4r_send(int64_t h, const uint8_t* data, int64_t len);
int64_t od4r_wait(int64_t h, int64_t timeout_us);
int64_t od4r_drain(int64_t h, uint8_t* buf, int64_t cap, int64_t* offs,
                   int64_t* lens, int64_t* ts_us, int64_t maxn);
void od4r_stats(int64_t h, int64_t* received, int64_t* dropped);
void od4r_close(int64_t h);
}

int main() {
  for (int round = 0; round < 5; ++round) {
    int64_t a = od4r_open(131, 12175, 1 << 20, "0.0.0.0");
    int64_t b = od4r_open(131, 12175, 1 << 20, "0.0.0.0");
    if (a <= 0 || b <= 0) {
      std::fprintf(stderr, "open failed (%ld, %ld)\n", long(a), long(b));
      return 2;  // environment without multicast; treated as skip upstream
    }
    std::vector<std::thread> ts;
    ts.emplace_back([a] {
      uint8_t msg[64];
      std::memset(msg, 'x', sizeof(msg));
      for (int i = 0; i < 200; ++i) od4r_send(a, msg, sizeof(msg));
    });
    for (int64_t h : {a, b}) {
      ts.emplace_back([h] {
        for (int i = 0; i < 50; ++i) od4r_wait(h, 2000);
      });
      ts.emplace_back([h] {
        int64_t rx, dr;
        for (int i = 0; i < 200; ++i) od4r_stats(h, &rx, &dr);
      });
      ts.emplace_back([h] {
        std::vector<uint8_t> buf(1 << 16);
        std::vector<int64_t> offs(256), lens(256), tsus(256);
        for (int i = 0; i < 50; ++i) {
          od4r_drain(h, buf.data(), buf.size(), offs.data(), lens.data(),
                     tsus.data(), 256);
        }
      });
    }
    // close b while its waiters/drainers are mid-call — the refcounted
    // close must drain them out safely
    std::this_thread::sleep_for(std::chrono::milliseconds(20));
    od4r_close(b);
    for (auto& t : ts) t.join();
    od4r_close(a);
  }
  std::puts("TSAN_DRIVER_OK");
  return 0;
}
