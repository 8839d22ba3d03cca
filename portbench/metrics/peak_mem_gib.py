"""The most device memory torch's allocator held from the start of the run
to the window's end (max_memory_allocated, peak reset at start), in GiB."""


def read(r):
    if not r.peak_bytes:
        return None
    return r.peak_bytes / 2**30
