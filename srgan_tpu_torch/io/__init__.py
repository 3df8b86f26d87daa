"""Host-side input runtime: the native reader and prefetcher."""
from srgan_tpu_torch.io.native import (NativeDatasetReader, NativePrefetcher,
                                       native_library_available)

__all__ = ["NativeDatasetReader", "NativePrefetcher",
           "native_library_available"]
