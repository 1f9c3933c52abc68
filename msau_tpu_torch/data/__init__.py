"""Host data side of the port: charset, pages, synthetic pages, box programs."""
