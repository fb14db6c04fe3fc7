"""The host graph layer: handles, events, configuration, the store façade,
the graph kernel and its bulk loader."""
