"""Link engines of the port: the keyed fast engine, the Monte-Carlo engine and BER theory."""
