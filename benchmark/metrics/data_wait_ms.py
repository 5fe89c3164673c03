"""data_wait_ms: the host's wait for the next batch (the prefetcher's
``next`` and the copies' launch), mean over the window's steps, host clock."""


def read(r):
    if not r.data_wait_s:
        return None
    return 1e3 * sum(r.data_wait_s) / len(r.data_wait_s)
