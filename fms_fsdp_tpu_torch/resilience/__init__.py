"""Host-side anomaly policy over the train step's non-finite flags."""
