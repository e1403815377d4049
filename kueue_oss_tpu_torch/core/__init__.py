"""Host control-plane layer of the port: store, queues, quota forest,
cycle snapshot."""
