"""The serving controller's distributed state: checkpoint/restore,
elastic membership and the telemetry digests of the hierarchy."""
