// Seeded REPRO001 fixture: C entry points (no_extern_launch is missing).
extern "C" int good_kernel_launch(const void* x, void* stream) { return 0; }

extern "C" {

int no_counter_launch(const void* x, void* stream) { return 0; }
int no_twin_launch(const void* x, void* stream) { return 0; }
int no_dispatch_launch(const void* x,
                       void* stream) {
  if (x) { return 1; }
  return 0;
}
int twin_undispatched_launch(const void* x, void* stream) { return 0; }
int no_test_launch(const void* x, void* stream) { return 0; }

}  // extern "C"

// C++ linkage: not an entry point
int no_extern_launch(const void* x, void* stream) { return 0; }
