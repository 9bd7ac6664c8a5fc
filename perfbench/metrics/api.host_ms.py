"""api.host_ms: host time a step inside the port's entry points, from the
call to its return.  Where the port waits inside a call for its device
work (as it does in the IFS step cell), the wait is in it, and the metric
reads about the whole step; it reads the enqueue cost only where the
calls return before their device work ends."""

SPANS = {"api": ["ectrans_tpu_torch:inv_trans",
                 "ectrans_tpu_torch:dir_trans"]}


def read(s):
    if "api" not in s.host_s:
        return None
    return s.per_step_ms(s.host_s["api"])
