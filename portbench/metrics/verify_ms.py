"""A relying party's time to strictly verify one container on the card:
the ``verify_proof`` calls' time summed over the window, over the
verifies in it."""


def read(run):
    done = run.verified
    return 1e3 * sum(r["verify_s"] for r in done) / len(done) if done else None
