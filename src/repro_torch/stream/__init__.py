"""Blocked host views of the data: ``BlockStore`` and reservoir sampling."""
