"""output_tokens_per_s: every token generated in the window (the first
tokens of admissions' prefills included) over the window's whole length."""


def read(run):
    w0, closed = run.window
    if not run.requests:
        return None
    n = sum(1 for r in run.requests for t in r["times"] if w0 < t <= closed)
    return n / (closed - w0)
