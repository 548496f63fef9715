"""Link engines of the port: the keyed fast engine and BER theory."""
