"""Sample summaries, overlap, energy sampling and schema-v2 record
emission."""
