"""The train step: loss, lr schedule, AdamW, clipping and the non-finite guard."""
