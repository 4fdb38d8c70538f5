"""Host-side graph data: the container, preparation and batching."""
