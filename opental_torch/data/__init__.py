"""Host-side data helpers (numpy): video-info and class-index parsing,
clip transforms."""
