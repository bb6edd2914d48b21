"""Distribution helpers: the telemetry wire codecs (`compression`)."""
