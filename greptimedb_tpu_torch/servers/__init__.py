"""Wire protocols: HTTP, InfluxDB line protocol, Prometheus remote
write and read."""
