"""AdamW with schedules and clipping, and int8 gradient compression."""
