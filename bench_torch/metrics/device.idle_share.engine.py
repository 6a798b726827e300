"""The engine cell's device.idle_share (metrics/device.idle_share.py), read
the same way; a metric of its own because it moves ttfa_p95_ms."""

from common import HERE, load_module

read = load_module(HERE / "metrics" / "device.idle_share.py").read
