"""Backend sync: host-clock ms of the benchmark's span around
`TorchBackend.synchronize()` (which ends in a device synchronize), mean a
traced frame."""


def read(t):
    if not t.sync_s:
        return None
    return 1e3 * sum(t.sync_s) / len(t.sync_s)
