"""Host ms a window in ``MarionetteStream.submit`` outside its waits for
the previous window's results (``cudaEventSynchronize``)."""
from benchmark.trace import range_list


def read(rec):
    spans = range_list(rec, "submit")
    if not spans or not rec.get("windows"):
        return None
    main = rec["main_thread"]
    waits = sum(e - s for n, s, e, th in rec["cpu_ops"]
                if th == main and n == "cudaEventSynchronize"
                and any(a <= s and e <= b for a, b in spans))
    return (sum(e - s for s, e in spans) - waits) / 1e6 / rec["windows"]
