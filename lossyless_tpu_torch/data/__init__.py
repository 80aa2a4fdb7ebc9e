"""Host data helpers."""
