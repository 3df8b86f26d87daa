"""Host-side input runtime: the native reader and prefetcher."""
