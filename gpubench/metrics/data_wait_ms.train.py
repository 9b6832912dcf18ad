"""Host milliseconds a window step waits in ``Prefetcher.next()``, mean a step."""


def read(run):
    return 1e3 * sum(run.data_wait_s) / len(run.data_wait_s) if run.data_wait_s else None
