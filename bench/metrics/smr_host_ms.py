"""Host ms a request outside the model, in every serving cell: over the
requests after the traced part, each request's wall time less the
seconds of its replicas' model calls (``GreedyDecoder.timings``, from a
call's first clock read to its last: the ``serve.call`` span's own
reads), over the requests.  What is left is the ordering, the simulator,
the request's JSON and the client."""

from bench.readers import untraced


def read(run):
    recs = untraced(run)[0]
    if not recs:
        return None
    host = sum(r["t1"] - r["t0"] - sum(r["prefill_s"]) - sum(r["decode_s"])
               for r in recs)
    return 1e3 * host / len(recs)
