"""Wire codecs, counter RNG and key derivation of the consensus exchange."""
