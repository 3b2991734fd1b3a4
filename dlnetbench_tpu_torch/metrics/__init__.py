"""Sample summaries and schema-v2 record emission."""
