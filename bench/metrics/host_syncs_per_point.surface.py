"""Host syncs per point: the CUDA runtime calls that block the host until
the card has drained (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``), made inside the traced window, over the
window's points: a count.  After each one the card's queue is empty, so
the card waits for whatever the host issues next.  A window without points
reads nothing."""

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")


def read(run):
    n = len(run.records)
    if not n:
        return None
    return sum(1 for e in run.traced.host if e.name in SYNCS) / n
