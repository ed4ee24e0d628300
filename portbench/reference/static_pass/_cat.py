"""Stand-in for the program's metrics catalog: the one counter the
copied taint pass feeds, kept in this process and read by nothing."""


class _Seconds:
    def __init__(self):
        self.total = 0.0

    def inc(self, v=1.0):
        self.total += v

    def value(self):
        return self.total

    def reset(self):
        self.total = 0.0


TAINT_PASS_S = _Seconds()
