"""AdamW with global-norm clipping, and int8 error-feedback compression."""
