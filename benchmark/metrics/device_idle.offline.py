"""Share of the traced window in which no kernel or copy ran on the card
(the union of its device spans)."""


def read(w):
    tr = w["trace"]
    if tr.window_s <= 0 or not tr.gpu:
        return None
    return 100.0 * (tr.window_s - tr.busy_s) / tr.window_s
