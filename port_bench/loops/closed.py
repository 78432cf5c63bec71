"""Loop ``closed``: one client; the next request goes out when the last
one's images are on the host; whole requests until ``seconds`` have
passed."""

import time


def drive(mix, one, seconds):
    """``one()`` serves the next request and says whether it succeeded."""
    if mix["clients"] != 1:
        raise ValueError("the closed loop runs one client")
    t0 = time.perf_counter()
    while one() and time.perf_counter() - t0 < seconds:
        pass
