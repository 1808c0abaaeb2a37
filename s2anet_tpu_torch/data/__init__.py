"""Host-side data: the DOTA dataset and batch loader, chip splitting and
cross-chip merging, without cv2."""
