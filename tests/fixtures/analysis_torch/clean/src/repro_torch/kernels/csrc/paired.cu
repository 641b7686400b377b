// Clean REPRO001 fixture: the kernel's C entry point.
extern "C" {

int paired_kernel_launch(const void* x, void* stream) { return 0; }

}  // extern "C"
